"""The port imports neither JAX nor flax, nor the JAX package, reads none
of its files (the greedy matcher is built from the port's own
csrc/matcher.cc), and loads without cv2, PIL, yaml and tensorboard, which
the card's machine lacks."""
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
    assert {"omni3d_tpu_torch.evaluation.omni3d_eval", "omni3d_tpu_torch.evaluation.native",
            "omni3d_tpu_torch.evaluation.error_stats", "omni3d_tpu_torch.ops.iou3d",
            "omni3d_tpu_torch.vis.logperf", "omni3d_tpu_torch.tools.bench_eval",
            "omni3d_tpu_torch.parallel", "omni3d_tpu_torch.parallel.dist",
            "omni3d_tpu_torch.data.jpeg", "omni3d_tpu_torch.utils.cxx",
            "omni3d_tpu_torch.utils.render", "omni3d_tpu_torch.vis.draw",
            "omni3d_tpu_torch.vis.vis", "omni3d_tpu_torch.tools.demo",
            "omni3d_tpu_torch.utils.benchtime", "omni3d_tpu_torch.tools.bench",
            "omni3d_tpu_torch.tools.bench_train", "omni3d_tpu_torch.tools.profile_stages",
            "omni3d_tpu_torch.tools.profile_backbone", "omni3d_tpu_torch.ops.nms_cuda",
            "omni3d_tpu_torch.utils.cuda_build", "omni3d_tpu_torch.tools.profile_nms"} <= set(mods)
    for p in (ROOT / "omni3d_tpu_torch").rglob("*.py"):
        text = p.read_text()
        assert '"native"' not in text and "native/" not in text, p
    code = (
        "import importlib, sys\n"
        "for name in ('cv2', 'PIL', 'yaml', 'tensorboard'): sys.modules[name] = None\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'omni3d_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)


def test_jpeg_reads_without_cv2_and_pil():
    """The port's own decoder reads a JPEG fixture with cv2 and PIL
    unimportable, bit-equal to the committed cv2 decode."""
    code = (
        "import sys\n"
        "for name in ('cv2', 'PIL'): sys.modules[name] = None\n"
        "from omni3d_tpu_torch.data.image import read_image_bgr\n"
        "a = read_image_bgr('tests/data/jpeg/q75_420_37x53.jpg')\n"
        "b = read_image_bgr('tests/data/jpeg/q75_420_37x53.png')\n"
        "assert a.shape == (37, 53, 3) and (a == b).all()\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)
