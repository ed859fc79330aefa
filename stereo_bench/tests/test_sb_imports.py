"""No module of the benchmark loads JAX or the JAX package, compared by
whole top-level names, and no reference loads anything of the port."""

import subprocess
import sys

import pytest

from stereo_bench import spec

ALL = """
import sys
sys.path.insert(0, {root!r})
from stereo_bench import (check, control, drive, harness, roofline, spec,
                          stats, trace, traffic)
from stereo_bench.reference import sgm
import stereo_bench.run
bench = spec.load_benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.reader(m["name"])
for w in bench["workloads"]:
    spec.feed(spec.traffic(w["traffic"])["feed"])
import soc_project_stereo_matching_tpu_torch
from soc_project_stereo_matching_tpu_torch.models import sgm as port_sgm
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REFERENCE_ONLY = """
import sys
sys.path.insert(0, {root!r})
from stereo_bench import check, spec
spec.reference({name!r})
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
REFERENCES = sorted(p.stem for p in spec.REFERENCE_DIR.glob("*.py"))


def top_levels(code, **kw):
    out = subprocess.run([sys.executable, "-c",
                          code.format(root=str(spec.CHECKOUT), **kw)],
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(spec.CHECKOUT)})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_no_module_loads_jax_or_the_jax_package():
    loaded = top_levels(ALL)
    assert "soc_project_stereo_matching_tpu_torch" in loaded
    assert "stereo_bench" in loaded
    assert not loaded & set(spec.FORBIDDEN)


@pytest.mark.parametrize("name", REFERENCES)
def test_the_reference_loads_nothing_of_the_port(name):
    loaded = top_levels(REFERENCE_ONLY, name=name)
    assert "soc_project_stereo_matching_tpu_torch" not in loaded
    assert not loaded & set(spec.FORBIDDEN)


def test_forbidden_names_are_compared_whole():
    modules = ["soc_project_stereo_matching_tpu_torch.ops", "jaxtyping",
               "opt_einsum.backends.jax", "numpy"]
    assert spec.forbidden_loaded(modules) == []
    assert spec.forbidden_loaded(modules + ["jax.numpy", "flax"]) == \
        ["flax", "jax.numpy"]
    assert spec.forbidden_loaded(["soc_project_stereo_matching_tpu.ops"]) == \
        ["soc_project_stereo_matching_tpu.ops"]
