"""Generate ``sonar_tpu_torch/api/schemas.py`` from ``tools/ref_schemas.json``.

    python -m sonar_tpu_torch.api._gen_schemas [--out PATH]

The field conversion (``convert_field``) and the literal layout
(``py_literal``) are ``tools/gen_schemas.py``'s, loaded by path, so the
port's table is the JAX package's table; only the header and the output
path differ. Nothing else is written.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "tools" / "ref_schemas.json"
OUT = Path(__file__).resolve().parent / "schemas.py"

HEADER = '''"""Reference node parameter schemas — GENERATED, do not edit.

Regenerate with:
    python -m sonar_tpu_torch.api._gen_schemas

One entry per reference node (py/nodes/* NODE_CLASS_MAPPINGS), one
field spec per widget/input. Field spec keys:
    t   - kind: f(float) i(int) b(bool) s(string) enum tri dyn x(link)
    d   - widget default
    lo/hi - numeric range
    opts  - static enum options
    dom   - dynamic domain name resolved against live registries
            (see sonar_tpu_torch.api.validate.DOMAINS); extras are
            additionally-allowed literals (e.g. 'DEFAULT')
    ty  - declared link type for object inputs
    r   - 1 if the reference declares the field required
"""

'''


def _converter():
    spec = importlib.util.spec_from_file_location("_ref_gen_schemas",
                                                  ROOT / "tools" / "gen_schemas.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def render() -> str:
    """The module text: the header and ``SCHEMAS``."""
    gen = _converter()
    src = json.loads(SOURCE.read_text())
    schemas: dict[str, dict] = {}
    for node, spec in sorted(src.items()):
        fields: dict[str, dict] = {}
        for section, required in (("required", True), ("optional", False)):
            for fname, entry in spec.get(section, {}).items():
                fields[fname] = gen.convert_field(fname, entry, required)
        schemas[node] = fields
    return HEADER + "SCHEMAS = " + gen.py_literal(schemas) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    text = render()
    args.out.write_text(text)
    print(f"wrote {args.out}: {text.count(chr(10))} lines")


if __name__ == "__main__":
    main()
