"""The port imports neither JAX nor flax, nor the JAX package, and loads
without cv2, PIL, yaml and tensorboard, which the card's machine lacks."""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_port_modules_load_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "omni3d_tpu_torch").rglob("*.py"))
    assert "omni3d_tpu_torch.ops.roi_align_cuda" in mods
    assert "omni3d_tpu_torch.tools.train_net" in mods and "omni3d_tpu_torch.data.image" in mods
    code = (
        "import importlib, sys\n"
        "for name in ('cv2', 'PIL', 'yaml', 'tensorboard'): sys.modules[name] = None\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'omni3d_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)
