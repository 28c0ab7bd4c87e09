"""Port config vs `omni3d_tpu.config`: defaults, every configs/*.yaml, the
YAML subset reader against PyYAML, and CLI overrides."""
import glob
import os
import subprocess
import sys

import pytest
import yaml

from omni3d_tpu.config import get_default_cfg as jax_cfg
from omni3d_tpu_torch.config import get_default_cfg as torch_cfg
from omni3d_tpu_torch.config.cfg import StaticCfg, read_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def plain(node):
    """CfgNode -> nested plain dicts, keeping list/tuple types."""
    if isinstance(node, dict):
        return {k: plain(v) for k, v in node.items()}
    return node


def test_defaults_equal():
    assert plain(torch_cfg()) == plain(jax_cfg())


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_merged_config_equal(path):
    a, b = torch_cfg(), jax_cfg()
    a.merge_from_file(path)
    b.merge_from_file(path)
    assert plain(a) == plain(b)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_matches_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert read_yaml(text) == yaml.safe_load(text)


def test_reader_constructs():
    text = """
# comment line
A:
  B: 1            # trailing comment
  C: 1.5
  D: "x # not a comment"
  E: 'it''s'
  F: [[1, 2], ['a', "b"], []]
  G: (1, 2,)
  H: true
  I: Off
  J:
  K: ~
  L: 1e5
  M: .5
N: -3
"""
    assert read_yaml(text) == yaml.safe_load(text)


def test_merge_from_list_and_freeze():
    opts = ["SOLVER.BASE_LR", "0.5", "MODEL.ROI_HEADS.NUM_CLASSES", "7",
            "SOLVER.STEPS", "(10, 20)", "DATASETS.TRAIN", "('a', 'b')"]
    a, b = torch_cfg(), jax_cfg()
    a.merge_from_list(opts)
    b.merge_from_list(opts)
    assert plain(a) == plain(b)
    assert a.SOLVER.STEPS == (10, 20) and a.MODEL.ROI_HEADS.NUM_CLASSES == 7
    with pytest.raises(KeyError):
        a.merge_from_list(["MODEL.NOT_A_KEY", "1"])
    s = StaticCfg(a.clone())
    assert hash(s) == hash(StaticCfg(a.clone())) and s.MODEL.DLA.TYPE == "dla34"
    a.freeze()
    with pytest.raises(AttributeError):
        a.SEED = 3


def test_loads_without_pyyaml():
    """The port reads configs with PyYAML unimportable (the card's machine
    has no PyYAML)."""
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "from omni3d_tpu_torch.config import get_default_cfg\n"
        "c = get_default_cfg(); c.merge_from_file('configs/cubercnn_DLA34_FPN.yaml')\n"
        "assert c.MODEL.ROI_HEADS.NUM_CLASSES == 50 and 'yaml' not in "
        "[m for m in sys.modules if sys.modules[m] is not None]\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize("path", [None] + CONFIGS,
                         ids=lambda p: "defaults" if p is None else os.path.basename(p))
def test_dump_equals_jax_and_round_trips(path, tmp_path):
    """`CfgNode.dump` is byte-equal to the JAX package's PyYAML dump for the
    defaults and each config merged into them; `save` writes it, and the
    port's reader and PyYAML read it back equal to the config."""
    a, b = torch_cfg(), jax_cfg()
    if path:
        a.merge_from_file(path)
        b.merge_from_file(path)
    text = a.dump()
    assert text == b.dump()
    a.save(str(tmp_path / "sub" / "config.yaml"))
    with open(tmp_path / "sub" / "config.yaml") as f:
        saved = f.read()
    assert saved == text
    want = yaml.safe_load(text)
    assert read_yaml(saved) == want
    assert want == {k: v for k, v in yaml.safe_load(b.dump()).items()}
    c = torch_cfg()
    c.merge_from_file(str(tmp_path / "sub" / "config.yaml"))
    assert c.dump() == text


def test_dump_yaml_scalar_styles():
    """Strings that need quoting, floats in PyYAML's forms, nested and empty
    containers: the bytes of `yaml.safe_dump(..., sort_keys=True)`."""
    from omni3d_tpu_torch.config.cfg import dump_yaml
    tree = {"s": ["", "true", "no", "1.5", "12", "a: b", "#x", "x #y", "it's", "-x", "- x",
                  ":x", "cubercnn://a/b", "é", " s", "null", "2020-01-01", "0x1F", "1e5",
                  "~", "a:b", "?x", "[a]", "@x", "x\ty", 'q"\\'],
            "n": [[1, [2, 3]], [], {}], "e": {}, "z": None, "m": [{"x": 1, "y": [1, 2]}],
            "f": [1e-5, 1e17, -0.0, float("inf"), float("-inf"), 3.0, 0.1 + 0.2, 100000000.0],
            "b": [True, False]}
    text = dump_yaml(tree)
    assert text == yaml.safe_dump(tree, sort_keys=True)
    back = read_yaml(text)
    assert back == yaml.safe_load(text)
    assert dump_yaml({}) == yaml.safe_dump({}) and read_yaml("") == {}
