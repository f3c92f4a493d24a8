"""The check that no JAX module was loaded compares whole top-level
names: the port's name begins with the JAX package's."""

from perfbench import harness


def test_flags_jax_and_the_jax_package():
    found = harness.forbidden_loaded(
        ["qkan_implementation_tpu.models", "qkan_implementation_tpu", "jax",
         "jax.numpy", "jaxlib.xla_client", "flax.linen", "numpy"])
    assert found == sorted(["qkan_implementation_tpu.models",
                            "qkan_implementation_tpu", "jax", "jax.numpy",
                            "jaxlib.xla_client", "flax.linen"])


def test_passes_the_port_and_lookalikes():
    assert harness.forbidden_loaded(
        ["qkan_implementation_tpu_torch", "qkan_implementation_tpu_torch.ops",
         "jaxtyping", "flaxx", "perfbench.run"]) == []


def test_a_cell_run_loads_no_jax(tmp_path):
    import subprocess
    import sys

    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch\n"
        "from perfbench import harness\n"
        "from perfbench.tests.conftest import small_cell\n"
        "from perfbench.run import run_cell\n"
        "cell = small_cell('digits-train')\n"
        "res = run_cell(cell, harness.driver_for(cell), 5, 0.1, False,"
        " torch.device('cpu'))\n"
        "print(harness.forbidden_loaded())\n" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
