"""The port's subpackages export what the JAX package's export, read from
both packages' ``__init__.py`` by AST (nothing is imported).

``noise``, ``samplers``, ``ops``, ``utils`` and ``core`` define
``__all__`` in both packages: the JAX package's names must all be in the
port's, except the omissions made on purpose (``core``: JAX's PRNG-key
API, ``derive_key`` and ``key_from_seed``, which the port's integer seeds
replace). ``cfg``, ``wavelets``, ``api``, ``models`` and ``parallel`` define
no ``__all__`` in the JAX package: every name its ``__init__.py`` imports
must be one the port's imports or lists, except the omissions (``models``:
the TPU's peak, which the H100's replaces).

No module of the port, and not ``chip_smoke.py``, imports ``jax`` or the JAX
package.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
OMITTED = {"core": {"derive_key", "key_from_seed"},
           "models": {"TPU_V5E_PEAK_FLOPS"}}


def _init(package: str, sub: str) -> ast.Module:
    return ast.parse((ROOT / package / sub / "__init__.py").read_text())


def _all(tree: ast.Module):
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return {ast.literal_eval(e) for e in node.value.elts}
    return None


def _imported(tree: ast.Module) -> set:
    """Names bound by ``from ... import`` (``from . import extensions`` too)."""
    return {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names}


def _defined(tree: ast.Module) -> set:
    """Names the module binds: imports, definitions and assignments."""
    names = _imported(tree)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


@pytest.mark.parametrize("sub", ["noise", "samplers", "ops", "utils", "core"])
def test_all_covers_the_jax_package(sub):
    want, got = _all(_init("sonar_tpu", sub)), _all(_init("sonar_tpu_torch", sub))
    assert want is not None and got is not None
    missing = want - got
    assert missing == OMITTED.get(sub, set()), missing
    assert got <= _defined(_init("sonar_tpu_torch", sub))  # every listed name exists


@pytest.mark.parametrize("sub", ["cfg", "wavelets", "api", "models", "parallel"])
def test_imports_cover_the_jax_package(sub):
    jax_tree = _init("sonar_tpu", sub)
    assert _all(jax_tree) is None
    port = _init("sonar_tpu_torch", sub)
    missing = _imported(jax_tree) - (_imported(port) | (_all(port) or set()))
    assert missing == OMITTED.get(sub, set()), missing


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports, at any depth of its
    code (imports inside functions too)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_port_imports_no_jax():
    files = sorted((ROOT / "sonar_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 50
    bad = {str(f.relative_to(ROOT)): sorted(_imports(f) & {"jax", "jaxlib", "sonar_tpu", "optax",
                                                            "flax", "orbax"})
           for f in files}
    assert not {k: v for k, v in bad.items() if v}, bad


def test_f8_names_import():
    from sonar_tpu_torch.utils import (StepTimer, adjust_slice, crop_samples,  # noqa: F401
                                       elementwise_shuffle_by_dim, pattern_break,
                                       step_from_sigmas_f32, step_from_sigmas_traced, trace,
                                       trunc_decimals)

    assert step_from_sigmas_traced is step_from_sigmas_f32
