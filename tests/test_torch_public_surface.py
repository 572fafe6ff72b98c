"""The port's public surface holds the reference's (ROADMAP C.21).

For each module of ``repro`` with an ``__all__`` (found by reading the
sources, so every worker collects the same cases), the ``repro_torch``
module of the same path has every listed name, in its own ``__all__``
too. A name left out must be a decision recorded in README and listed in
``RECORDED``. ``parse_precisions`` is held against the reference's on
the specs the benchmark scripts pass and on bad entries.
"""
import ast
import importlib
from pathlib import Path

import pytest

from repro.kernels import precision as ref_precision
from repro_torch.kernels import precision as port_precision

SRC = Path(__file__).resolve().parent.parent / "src"

# {reference module: names with a decision recorded in README and no
# counterpart in the port}. None today.
RECORDED: dict = {}


def _modules_with_all():
    """The reference's module names whose source assigns ``__all__`` at
    top level."""
    out = []
    for path in sorted((SRC / "repro").rglob("*.py")):
        tree = ast.parse(path.read_text())
        if any(isinstance(node, ast.Assign)
               and any(getattr(t, "id", None) == "__all__"
                       for t in node.targets) for node in tree.body):
            parts = path.relative_to(SRC).with_suffix("").parts
            if parts[-1] == "__init__":
                parts = parts[:-1]
            out.append(".".join(parts))
    return out


MODULES = _modules_with_all()


def test_the_walk_finds_the_modules_of_c21():
    assert {"repro.core.smo", "repro.core.engine", "repro.core",
            "repro.serve", "repro.kernels"} <= set(MODULES)


@pytest.mark.parametrize("name", MODULES)
def test_port_module_has_every_public_name(name):
    try:
        ref = importlib.import_module(name)
    except ImportError as e:     # a module that needs a TPU or a mesh
        pytest.skip(f"{name} does not import on the CPU: {e}")
    port = importlib.import_module("repro_torch" + name[len("repro"):])
    recorded = set(RECORDED.get(name, ()))
    missing = [n for n in ref.__all__
               if n not in recorded and not hasattr(port, n)]
    assert not missing, f"{name}: {missing}"
    unlisted = [n for n in ref.__all__
                if n not in recorded and n not in getattr(port, "__all__",
                                                          ())]
    assert not unlisted, f"{name}: not in the port's __all__: {unlisted}"


def test_c21_names_import_from_the_port():
    from repro_torch.core.engine import FusedGram, PallasGram
    from repro_torch.core.engine.gram import raw_scores_blocked as blocked
    from repro_torch.core.smo import raw_scores_blocked
    assert PallasGram is FusedGram and PallasGram.name == "pallas"
    assert raw_scores_blocked is blocked
    assert callable(port_precision.parse_precisions)


@pytest.mark.parametrize("spec", ["", "f32", " bf16 , f16,", "f16,f32",
                                  " , ,", "bf16"])
def test_parse_precisions_matches_the_reference(spec):
    got = port_precision.parse_precisions(spec)
    assert got == ref_precision.parse_precisions(spec)
    assert isinstance(got, tuple)


@pytest.mark.parametrize("spec", ["f64", "f32,fp8", " bf16 , F16", "tf32,"])
def test_parse_precisions_raises_where_the_reference_does(spec):
    with pytest.raises(ValueError) as want:
        ref_precision.parse_precisions(spec)
    with pytest.raises(ValueError) as got:
        port_precision.parse_precisions(spec)
    assert str(got.value) == str(want.value)
