"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port (top-level names compared whole)."""

import json
import subprocess
import sys

from meshbench import manifest

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _loaded(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)],
                         cwd=manifest.ROOT, capture_output=True, text=True,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    readers = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in readers["end_to_end"] + readers["per_layer"]]
    imports = "\n".join(
        ["import meshbench.run, meshbench.jobs, meshbench.trace, "
         "meshbench.calibrate, meshbench.reference.judge",
         "import turbomesh_tpu_torch.smoothing.device, "
         "turbomesh_tpu_torch.ops.zebra, turbomesh_tpu_torch.input"]
        + [f"import meshbench.metrics.{n}" for n in names])
    tops = _loaded(imports)
    assert "turbomesh_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "turbomesh_tpu"}


def test_reference_imports_nothing_of_the_port():
    tops = _loaded("import meshbench.reference.judge, meshbench.generator, "
                   "meshbench.roofline")
    assert not tops & {"turbomesh_tpu_torch", "turbomesh_tpu", "jax",
                       "jaxlib", "torch"}
