"""No module a run loads may be JAX's or the JAX package's, compared by
its whole top-level name."""

import subprocess
import sys

from conftest import REPO

from rtbench import harness


def test_top_level_names_compared_whole():
    mods = ["tpu_raytracing_torch", "tpu_raytracing_torch.app.main", "jaxtyping",
            "flaxen.x", "numpy"]
    assert harness.forbidden_loaded(mods) == []
    assert harness.forbidden_loaded(mods + ["tpu_raytracing.trace"]) == ["tpu_raytracing"]
    assert harness.forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """The harness, the reference and every module of the program a cell
    drives, imported in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from rtbench import harness, judge, reference, control\n"
        "import tpu_raytracing_torch.app.main, tpu_raytracing_torch.trace.pathtrace\n"
        "import tpu_raytracing_torch.trace.render, tpu_raytracing_torch.trace.wide_fat\n"
        "import tpu_raytracing_torch.bvh.refit_schedule, tpu_raytracing_torch.bvh.bucket\n"
        "print(harness.forbidden_loaded())\n" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=REPO)
    assert out.stdout.strip() == "[]"


def test_the_yardstick_imports_nothing_of_the_program():
    """The reference, the comparison, the roofline and the trace reduction
    import neither the program nor JAX."""
    for name in ("reference.py", "judge.py", "roofline.py", "tracefold.py"):
        src = (REPO / "rtbench" / name).read_text()
        for word in ("import tpu_raytracing", "from tpu_raytracing", "import jax", "from jax"):
            assert word not in src, (name, word)
