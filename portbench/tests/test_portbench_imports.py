"""What the benchmark loads: never JAX nor the JAX package (their
top-level names compared whole, since the port's name begins with the JAX
package's), and the reference nothing of the port either."""

import json
import subprocess
import sys
from pathlib import Path

from portbench import cell

ROOT = Path(__file__).resolve().parents[2]


def _top_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=600).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_portbench_a_cpu_run_loads_no_jax():
    names = _top_names(
        "import json, sys; sys.path.insert(0, '.')\n"
        "from portbench import cell\n"
        "from portbench.tests.small import overrides\n"
        "line = cell.run('batch_scan.equal', 7, 0.5, True, 'cpu',"
        " overrides=overrides('batch_scan.equal'), say=lambda s: None)\n"
        "assert line['correct'], line\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    assert "audio_matcher_tpu_torch" in names
    assert not names & set(cell.FORBIDDEN)


def test_portbench_the_reference_imports_nothing_of_the_program():
    names = _top_names(
        "import json, sys; sys.path.insert(0, '.')\n"
        "import portbench.reference.xcorr_peaks\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    assert not names & {"audio_matcher_tpu_torch", *cell.FORBIDDEN}


def test_portbench_forbidden_names_are_compared_whole(monkeypatch):
    fake = dict(sys.modules)
    for name in ("audio_matcher_tpu_torch.ops", "jaxtyping", "flaxen"):
        fake.setdefault(name, None)
    monkeypatch.setattr(sys, "modules", fake)
    assert cell.forbidden_modules() == []
    fake["audio_matcher_tpu.ops"] = None
    fake["jax.numpy"] = None
    assert cell.forbidden_modules() == ["audio_matcher_tpu.ops", "jax.numpy"]
