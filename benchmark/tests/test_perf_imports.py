"""Nothing a run loads may be JAX or the JAX package, names compared
whole: the port's name begins with the JAX package's."""
import subprocess
import sys

from benchmark import run


def test_whole_name_comparison():
    assert run.forbidden_modules(["isogs_slam_tpu_torch",
                                  "isogs_slam_tpu_torch.slam.pipeline",
                                  "jaxtyping", "flaxen"]) == []
    assert run.forbidden_modules(["isogs_slam_tpu.ops", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == \
        ["flax", "isogs_slam_tpu", "jax", "jaxlib"]


def test_harness_and_port_load_no_jax():
    code = ("import sys; import benchmark.run, benchmark.judge, "
            "benchmark.control, benchmark.trace, benchmark.scene; "
            "import isogs_slam_tpu_torch.slam.pipeline; "
            "from benchmark.run import forbidden_modules; "
            "print(forbidden_modules(list(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
