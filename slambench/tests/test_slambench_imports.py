"""Nothing the harness or the reference loads is JAX or the JAX package, the
reference loads nothing of the program, and nothing under slambench/ reads
the JAX package's benchmark records."""
import json
import re
import subprocess
import sys

import pytest

from slambench import spec

HARNESS = ["slambench.run", "slambench.calibrate", "slambench.check", "slambench.loop",
           "slambench.program", "slambench.spec", "slambench.stats", "slambench.trace",
           "slambench.roofline", "slambench.traffic.ring"]
# every module under reference/, found by its file, so a new reference is checked unlisted
REFERENCE = sorted(f"slambench.reference.{p.stem}"
                   for p in (spec.BENCH_DIR / "reference").glob("*.py") if p.name != "__init__.py")


def _top_levels(modules):
    code = ("import json, sys\n" + "".join(f"import {m}\n" for m in modules)
            + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    tops = _top_levels(HARNESS + ["uwslam_tpu_torch.system", "uwslam_tpu_torch.cli.main"])
    assert not tops & {"jax", "jaxlib", "flax", "uwslam_tpu"}
    assert "uwslam_tpu_torch" in tops     # the whole name, not its prefix


def test_reference_loads_neither_jax_nor_the_program():
    tops = _top_levels(REFERENCE)
    assert not tops & {"jax", "jaxlib", "flax", "uwslam_tpu", "uwslam_tpu_torch"}


def test_every_module_is_listed():
    files = {str(p.relative_to(spec.ROOT).with_suffix("")).replace("/", ".")
             for p in spec.BENCH_DIR.rglob("*.py")
             if "tests" not in p.parts and "metrics" not in p.parts and p.name != "__init__.py"}
    assert files == set(HARNESS) | set(REFERENCE)


@pytest.mark.parametrize("pattern", [r"(?<![\w/])benchmarks/", r"(?<![\w/])bench\.py",
                                     r"BENCH_r\d", r"MICRO_(TORCH_)?r\d", r"MULTICHIP_r\d"])
def test_nothing_reads_the_jax_package_s_records(pattern):
    for p in spec.BENCH_DIR.rglob("*"):
        if p.is_file() and p.suffix in (".py", ".json") and "tests" not in p.parts:
            assert not re.search(pattern, p.read_text()), p
