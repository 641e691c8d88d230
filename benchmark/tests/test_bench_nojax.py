"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program (top-level module names compared
whole: the port's name begins with the JAX package's)."""

import json
import subprocess
import sys

from benchmark import registry

PROBE = ("import json, sys\n"
         "{imports}\n"
         "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))\n")


def loaded(imports: str) -> set:
    res = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)],
                         capture_output=True, text=True, check=True, cwd=registry.ROOT,
                         timeout=300)
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = loaded("import benchmark.run, benchmark.control, benchmark.reference, "
                  "benchmark.reference.ba\nimport emba_tpu_torch.pipeline")
    assert not mods & {"jax", "jaxlib", "flax", "emba_tpu"}
    assert "emba_tpu_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = loaded("import benchmark.reference, benchmark.reference.ba, "
                  "benchmark.reference.geometry, benchmark.reference.rmse, benchmark.check")
    assert not mods & {"jax", "jaxlib", "flax", "emba_tpu", "emba_tpu_torch"}
