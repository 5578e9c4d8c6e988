"""YAML configuration surface (port of ``sonar_tpu.api.config``): the
reference's three escape hatches with identical key names, so existing
snippets port verbatim (SURVEY §5.6):

1. ``sonar_params`` blocks overriding SonarConfig fields incl.
   enums-by-name (py/sonar.py:98-131, README.md:71-106);
2. ``yaml_parameters`` → generator ``ns_kwargs`` (py/noise.py:31-41);
3. Wavelet-CFG rule documents (py/nodes/misc.py:670-796).

PyYAML is imported only where a YAML text is parsed, so the package
imports without it; a YAML text given where it is missing raises an
``ImportError`` that names it.
"""

from __future__ import annotations

from ..cfg import WaveletCFG, WCFGRules
from ..samplers.momentum import SonarConfig


def safe_load_yaml(text: str):
    """``yaml.safe_load(text)``; an ``ImportError`` naming PyYAML where the
    module is missing."""
    try:
        import yaml
    except ImportError as exc:
        raise ImportError(
            "parsing a YAML text needs PyYAML (the 'yaml' module), which is not "
            "installed") from exc
    return yaml.safe_load(text)


def load_yaml_params(text: str | None) -> dict:
    """Parse a ``yaml_parameters`` block into kwargs (must be a mapping)."""
    if not text or not text.strip():
        return {}
    parsed = safe_load_yaml(text)
    if parsed is None:
        return {}
    if not isinstance(parsed, dict):
        raise ValueError("YAML parameters must parse to a mapping")
    return parsed


def sonar_config_from_yaml(text: str | None,
                           base: SonarConfig | None = None) -> SonarConfig:
    """Apply a ``sonar_params`` YAML override block (py/sonar.py:104-131)."""
    params = load_yaml_params(text)
    return (base or SonarConfig()).updated(params)


def wcfg_rules_from_yaml(text: str | None, **node_fields) -> WCFGRules:
    """Build WCFG rules from a YAML document merged over node fields
    (py/nodes/misc.py:846-896)."""
    params = dict(node_fields)
    params |= load_yaml_params(text)
    return WCFGRules.build(**params)


def wavelet_cfg_from_yaml(text: str | None, *, existing_cfg=None,
                          **node_fields) -> WaveletCFG:
    return WaveletCFG(rules=wcfg_rules_from_yaml(text, **node_fields),
                      existing_cfg=existing_cfg)
