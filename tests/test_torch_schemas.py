"""The port's node schemas and their validation (``sonar_tpu_torch.api.schemas``,
``validate``) against the JAX package's, on the CPU.

- ``SCHEMAS`` is equal to the JAX package's table, and the port's
  generator (``python -m sonar_tpu_torch.api._gen_schemas``), run into a
  temporary file, reproduces the committed module byte for byte.
- Each dynamic domain (noise types, blend modes, resample modes,
  distributions, quantile strategies, filter presets, enhance modes)
  resolves to the same set against each package's own registries.
- ``validate_params`` accepts and rejects the cases of
  ``tests/test_schema_validation.py`` in both packages with the same
  message, the package's name aside (the ``model`` adaptation names the
  package's ``cfg.model_sampling``).
"""

import pytest

import sonar_tpu.api.nodes as JN
import sonar_tpu.api.validate as JV
import sonar_tpu_torch.api.nodes as TN
import sonar_tpu_torch.api.validate as TV
from sonar_tpu.api.schemas import SCHEMAS as J_SCHEMAS
from sonar_tpu_torch.api import _gen_schemas
from sonar_tpu_torch.api.schemas import SCHEMAS

NODES = sorted(SCHEMAS)


def test_schemas_equal_the_jax_package():
    assert SCHEMAS == J_SCHEMAS
    assert len(SCHEMAS) == 54


def test_generator_reproduces_the_committed_file(tmp_path):
    out = tmp_path / "schemas.py"
    _gen_schemas.main(["--out", str(out)])
    assert out.read_bytes() == _gen_schemas.OUT.read_bytes()
    assert "python -m sonar_tpu_torch.api._gen_schemas" in out.read_text()


def test_tables_of_adaptations_equal_the_jax_package():
    assert TV.ALIASES == JV.ALIASES
    assert set(TV.ADAPT) == set(JV.ADAPT)
    for node, adapt in JV.ADAPT.items():
        port = TV.ADAPT[node]
        assert port.get("extra") == adapt.get("extra"), node
        assert set(port.get("removed", {})) == set(adapt.get("removed", {})), node


@pytest.mark.parametrize("dom", sorted(JV.DOMAINS))
def test_dynamic_domains_resolve_to_the_same_sets(dom):
    jfn, tfn = JV.DOMAINS[dom], TV.DOMAINS[dom]
    assert (jfn is None) == (tfn is None)
    if jfn is not None:
        assert tfn() == jfn() and tfn()


def _message(validate, node, params):
    try:
        validate(node, params)
    except ValueError as exc:
        return str(exc).replace("sonar_tpu_torch", "sonar_tpu")
    return None


def _cases(node):
    """(label, params) of the schema-validation sweep: every widget at its
    default, an unknown name, a numeric range violation, an enum violation,
    a removed parameter and a wrong type."""
    schema = SCHEMAS[node]
    widgets = {f: s["d"] for f, s in schema.items()
               if s["t"] != "x" and s.get("d") is not None}
    yield "defaults", widgets
    yield "unknown", {**widgets, "definitely_not_a_param_9000": 1}
    for f, s in schema.items():
        if s["t"] in ("f", "i") and s.get("hi") is not None:
            yield f"range {f}", {f: s["hi"] + (1 if s["t"] == "i" else 1e6)}
            yield f"type {f}", {f: "1.0"}
        if s["t"] in ("enum", "dyn", "tri"):
            yield f"enum {f}", {f: "__not_a_real_option__"}
            yield f"enum-type {f}", {f: 3}
        if s["t"] == "b":
            yield f"bool {f}", {f: 1}
    for f in JV.ADAPT.get(node, {}).get("removed", {}):
        yield f"removed {f}", {f: object()}


@pytest.mark.parametrize("node", NODES)
def test_validation_accepts_and_rejects_the_same_cases(node):
    n = 0
    for label, params in _cases(node):
        want = _message(JV.validate_params, node, params)
        got = _message(TV.validate_params, node, params)
        assert got == want, (node, label)
        n += want is not None
    assert n >= 1  # every node rejects something


def test_the_typo_of_the_review_and_the_escape_hatch():
    with pytest.raises(ValueError, match="momemtum"):
        TN.build("SamplerSonarEulerA", momemtum=2)
    chain = TN.build("SonarCustomNoise", _validate=False, factor=1.0, noise_type="gaussian",
                     not_a_widget=3)
    assert len(chain.items) == 1


def test_unknown_node_message():
    with pytest.raises(ValueError) as j:
        JN.build("NoSuchNode")
    with pytest.raises(ValueError) as t:
        TN.build("NoSuchNode")
    assert str(t.value) == str(j.value)


def test_registered_extension_values_are_valid_in_both_registries():
    """A domain reads the live registry: a name registered into the port's
    blend modes is valid at once, and only in the port."""
    from sonar_tpu_torch.core.blend import BLENDING_MODES

    params = {"blend_mode": "testext_schema_blend"}
    assert _message(TV.validate_params, "SonarBlendedNoise", params) is not None
    BLENDING_MODES["testext_schema_blend"] = lambda a, b, t: a
    try:
        assert _message(TV.validate_params, "SonarBlendedNoise", params) is None
        assert _message(JV.validate_params, "SonarBlendedNoise", params) is not None
    finally:
        del BLENDING_MODES["testext_schema_blend"]
