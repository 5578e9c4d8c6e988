"""ComfyUI workflow porting (port of ``sonar_tpu.api.workflow``) — build the
sonar subgraph of a workflow.

Every reference example image embeds the ComfyUI "prompt" graph that
produced it (docs/advanced_noise_nodes.md:35-39 in the reference): a JSON
dict ``{node_id: {"class_type": str, "inputs": {name: value | [src_id,
out_idx]}}}``. :func:`port_workflow` walks that graph and builds every
node this framework implements (api/nodes.py builders, all 54 reference
names) into live framework objects, resolving inter-node links
recursively and adapting the ComfyUI host inputs:

- ``model`` links become the caller's ``model_sampling`` (the only thing
  the reference nodes use MODEL for is percent→sigma / timestep);
- LATENT/MASK/IMAGE links from host nodes are looked up in ``externals``
  (keyed ``"<node_id>.<input>"`` or just ``"<input>"``); a numpy external
  becomes a tensor on the card once, when the workflow is ported, and
  tensors stay where they are;
- optional ``*_opt`` links into host nodes are dropped with a warning;
- host nodes (checkpoint loaders, samplers, VAE, ...) are reported in
  ``skipped`` — they have no meaning outside ComfyUI.

The result's :attr:`PortResult.noise_roots` are the built noise chains no
other built node consumes — the workflow's end-product noise, ready for
``make_noise_sampler``.

One adaptation differs from the JAX package: the Sonar sampler nodes hand
their ``custom_noise_opt`` input to ``SonarConfig.custom_noise``, as the
reference does (api/nodes.py ``_sonar_config``); the JAX package's builders
drop it.
"""

from __future__ import annotations

import inspect
import json
import struct
import zlib
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .nodes import NODES, _as_tensor, build

__all__ = ["read_png_metadata", "read_workflow", "port_workflow",
           "pipeline_from_workflow", "PortResult"]

# HOST nodes that invoke sampling (never built here — the model lives with
# the caller) whose literal widgets carry the run configuration
HOST_SAMPLER_INVOKERS = frozenset({
    "SamplerCustom", "SamplerCustomAdvanced", "KSampler", "KSamplerAdvanced",
})

# node classes whose built object is a sampler callable (model, x, sigmas)
SAMPLER_NODE_CLASSES = frozenset({
    "SamplerSonarEuler", "SamplerSonarEulerA", "SamplerSonarDPMPPSDE",
    "SamplerConfigOverride", "KRestartSamplerCustomNoise",
    "RestartSamplerCustomNoise", "KSamplerSelect",
})


def read_png_metadata(path) -> dict[str, str]:
    """All tEXt/zTXt/iTXt key→value pairs of a PNG (stdlib only)."""
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    out: dict[str, str] = {}
    pos = 8
    while pos + 8 <= len(data):
        ln, typ = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + ln]
        if typ == b"tEXt":
            k, _, v = chunk.partition(b"\x00")
            out[k.decode("latin-1")] = v.decode("latin-1")
        elif typ == b"zTXt":
            k, _, rest = chunk.partition(b"\x00")
            out[k.decode("latin-1")] = zlib.decompress(rest[1:]).decode(
                "latin-1")
        elif typ == b"iTXt":
            k, _, rest = chunk.partition(b"\x00")
            comp_flag = rest[0]
            body = rest[2:]
            for _ in range(2):  # language tag, translated keyword
                _, _, body = body.partition(b"\x00")
            text = zlib.decompress(body) if comp_flag else body
            out[k.decode("latin-1")] = text.decode("utf-8", "replace")
        elif typ == b"IEND":
            break
        pos += 12 + ln
    return out


def read_workflow(source) -> dict:
    """The ComfyUI prompt graph from a PNG path, JSON path/string, or an
    already-parsed dict."""
    if isinstance(source, dict):
        return source
    s = str(source)
    if s.lstrip().startswith("{"):
        return json.loads(s)
    if s.lower().endswith(".png"):
        meta = read_png_metadata(s)
        if "prompt" not in meta:
            raise ValueError(f"{s}: no embedded ComfyUI prompt metadata")
        return json.loads(meta["prompt"])
    with open(s) as fh:
        return json.load(fh)


@dataclass
class PortResult:
    built: dict[str, Any] = field(default_factory=dict)
    classes: dict[str, str] = field(default_factory=dict)
    skipped: dict[str, str] = field(default_factory=dict)
    failed: dict[str, str] = field(default_factory=dict)
    warnings: list[str] = field(default_factory=list)
    consumed: set = field(default_factory=set)
    # literal widget values harvested off the HOST sampler-invocation node
    # (SamplerCustom / KSampler(Advanced)): cfg, noise_seed/seed, and —
    # for the KSampler family — sampler_name/scheduler/steps/denoise.
    # pipeline_from_workflow uses these as pipeline defaults so a ported
    # workflow runs with ITS cfg scale, seed, and sampler selection.
    host_sampler: dict = field(default_factory=dict)

    @property
    def sigmas(self):
        """The last scheduler node's sigma schedule, if the workflow
        carried one (BasicScheduler / *Scheduler nodes build natively)."""
        out = None
        for nid, obj in self.built.items():
            if self.classes[nid].endswith("Scheduler"):
                out = obj
        return out

    def host_sigmas(self, model_sampling=None):
        """A sigma schedule from the host KSampler(Advanced) widgets, when
        the workflow carried no native scheduler node (scheduler + steps
        + denoise; start/end_at_step windows are not applied)."""
        hs = self.host_sampler
        if "scheduler" not in hs or "steps" not in hs:
            return None
        from ..samplers.schedules import get_sigmas

        return get_sigmas(hs["scheduler"], int(hs["steps"]), model_sampling,
                          denoise=float(hs.get("denoise", 1.0)))

    @property
    def noise_roots(self) -> dict[str, Any]:
        """Built noise items no other built node consumed (the workflow's
        end-product noise chains)."""
        from ..noise.base import NoiseItem

        return {nid: obj for nid, obj in self.built.items()
                if isinstance(obj, NoiseItem) and nid not in self.consumed}

    def summary(self) -> str:
        lines = [f"built {len(self.built)} sonar node(s): "
                 + ", ".join(sorted({self.classes[i] for i in self.built}))]
        if self.skipped:
            lines.append(f"skipped {len(self.skipped)} host node(s): "
                         + ", ".join(sorted(set(self.skipped.values()))))
        if self.failed:
            lines += [f"FAILED {nid} ({self.classes.get(nid)}): {msg}"
                      for nid, msg in self.failed.items()]
        lines += [f"warning: {w}" for w in self.warnings]
        return "\n".join(lines)


# names that old workflows embed but the reference itself later renamed
# (reference changelog.md:101-102 — "implementation was incorrect" renames;
# :156 — studentt_test was the interim name of today's studentt)
LEGACY_NOISE_TYPES = {"pink": "pink_old", "power": "power_old",
                      "studentt_test": "studentt"}
_TRISTATE = ("default", "forced", "disabled")


def _is_link(v, graph) -> bool:
    return (isinstance(v, (list, tuple)) and len(v) == 2
            and isinstance(v[0], str) and isinstance(v[1], int)
            and v[0] in graph)


def port_workflow(source, *, model_sampling=None, externals=None,
                  validate: bool = True) -> PortResult:
    """Build every sonar node of a ComfyUI workflow. See module docs.
    Numpy externals move to the card here, once."""
    graph = {nid: node for nid, node in read_workflow(source).items()
             if isinstance(node, dict)}  # tolerate non-node top-level junk
    externals = {k: _as_tensor(v) if isinstance(v, np.ndarray) else v
                 for k, v in (externals or {}).items()}
    res = PortResult()
    res.classes = {nid: node.get("class_type", "?")
                   for nid, node in graph.items()}
    building: set[str] = set()

    def default_ms():
        nonlocal model_sampling
        if model_sampling is None:
            from ..cfg import DiscreteSampling

            model_sampling = DiscreteSampling()
            res.warnings.append(
                "no model_sampling given: using DiscreteSampling() defaults "
                "for percent->sigma conversions")
        return model_sampling

    def resolve(nid: str):
        if nid in res.built:
            return res.built[nid]
        if nid in res.skipped or nid in res.failed:
            return None
        cls = res.classes[nid]
        if cls not in NODES:
            res.skipped[nid] = cls
            return None
        if nid in building:
            raise ValueError(f"workflow cycle through node {nid} ({cls})")
        building.add(nid)
        try:
            obj = _build_node(nid, cls)
        except Exception as exc:  # noqa: BLE001 — collect per-node failures
            res.failed[nid] = f"{type(exc).__name__}: {exc}"
            obj = None
        finally:
            building.discard(nid)
        if obj is not None:
            res.built[nid] = obj
        return obj

    def _build_node(nid: str, cls: str):
        sig = inspect.signature(NODES[cls])
        params = {}
        for name, value in graph[nid].get("inputs", {}).items():
            if not _is_link(value, graph):
                if (name in ("noise_type", "rand_init_noise_type")
                        and value in LEGACY_NOISE_TYPES):
                    res.warnings.append(
                        f"{nid} ({cls}): legacy noise type {value!r} -> "
                        f"{LEGACY_NOISE_TYPES[value]!r} (reference "
                        "changelog rename)")
                    value = LEGACY_NOISE_TYPES[value]
                elif (name.startswith("normalize") and isinstance(value, str)
                        and value not in _TRISTATE):
                    # ancient widget layouts stored unrelated strings here
                    res.warnings.append(
                        f"{nid} ({cls}): dropped legacy {name}={value!r} "
                        "(not a tristate; using the default)")
                    continue
                params[name] = value
                continue
            src_id = value[0]
            if res.classes[src_id] in NODES:
                child = resolve(src_id)
                if child is None:
                    raise ValueError(
                        f"input {name!r} depends on {src_id} "
                        f"({res.classes[src_id]}) which failed to build")
                res.consumed.add(src_id)
                params[name] = child
                continue
            # link into a host node: adapt or drop
            if name == "model":
                params["model_sampling"] = default_ms()
                continue
            key_specific = f"{nid}.{name}"
            if key_specific in externals or name in externals:
                params[name] = externals.get(key_specific, externals.get(name))
                continue
            p = sig.parameters.get(name)
            optional = (name.endswith("_opt")
                        or (p is not None and p.default is not p.empty)
                        or (p is None
                            and any(q.kind is q.VAR_KEYWORD
                                    for q in sig.parameters.values())))
            if optional:
                res.warnings.append(
                    f"{nid} ({cls}): dropped optional host input {name!r} "
                    f"from {res.classes[src_id]}")
                continue
            raise ValueError(
                f"required host input {name!r} comes from a "
                f"{res.classes[src_id]} node; supply externals["
                f"'{key_specific}'] or externals['{name}']")
        if ("model_sampling" in sig.parameters
                and "model_sampling" not in params):
            params["model_sampling"] = default_ms()
        # required builder params the workflow cannot carry (e.g.
        # FreeUExtreme's model_channels, which ComfyUI reads off the MODEL)
        for pname, p in sig.parameters.items():
            if (p.default is p.empty and p.kind is p.KEYWORD_ONLY
                    and pname not in params and pname in externals):
                params[pname] = externals[pname]
        return build(cls, _validate=validate, **params)

    for nid in graph:
        resolve(nid)
    for nid, node in graph.items():
        if res.classes[nid] in HOST_SAMPLER_INVOKERS:
            ins = {k: v for k, v in node.get("inputs", {}).items()
                   if not _is_link(v, graph)}
            picked = {k: ins[k] for k in
                      ("cfg", "noise_seed", "seed", "sampler_name",
                       "scheduler", "steps", "denoise", "add_noise")
                      if k in ins}
            if picked:
                res.host_sampler = picked  # last invoker wins
    return res


def pipeline_from_workflow(source, *, model, model_uncond=None,
                           model_sampling=None, externals=None,
                           sampler_node: str | None = None,
                           validate: bool = True, **pipeline_kwargs):
    """Assemble a runnable :class:`~sonar_tpu_torch.api.SonarPipeline` from a
    ported workflow: its sonar sampler node (momentum config, guidance,
    attached custom noise) plus any unconsumed noise chain, wavelet CFG,
    and latent operations, with the caller's denoiser(s).

    Returns ``(pipeline, port_result)``. When the workflow contains several
    sampler nodes (the reference example images often compare two), pass
    ``sampler_node=<node_id>`` — otherwise the last one is used and a
    warning lists the alternatives.
    """
    from ..cfg.wavelet_cfg import WaveletCFG
    from .pipeline import SonarPipeline

    res = port_workflow(source, model_sampling=model_sampling,
                        externals=externals, validate=validate)
    samplers = {nid: obj for nid, obj in res.built.items()
                if res.classes[nid] in SAMPLER_NODE_CLASSES}
    sampler = None
    if sampler_node is not None:
        if sampler_node not in samplers:
            raise ValueError(
                f"sampler_node {sampler_node!r} is not a built sampler node"
                + (f" (it failed: {res.failed[sampler_node]})"
                   if sampler_node in res.failed else "")
                + f"; built sampler nodes: {sorted(samplers) or 'none'}")
        sampler = samplers[sampler_node]
    elif samplers:
        # prefer UNCONSUMED sampler nodes: a KSamplerSelect feeding a
        # SamplerConfigOverride is an ingredient, not the workflow's
        # end-product sampler
        final = {nid: obj for nid, obj in samplers.items()
                 if nid not in res.consumed} or samplers
        nid = list(final)[-1]
        sampler = final[nid]
        if len(final) > 1:
            res.warnings.append(
                "multiple sampler nodes: using "
                f"{nid} ({res.classes[nid]}); alternatives: "
                + ", ".join(f"{i} ({res.classes[i]})"
                            for i in final if i != nid))
    wcfgs = [obj for obj in res.built.values() if isinstance(obj, WaveletCFG)]
    kwargs = dict(pipeline_kwargs)
    if sampler is not None:
        kwargs.setdefault("sampler", sampler)
    # the workflow's OWN run configuration (cfg scale, seed, and — for the
    # KSampler family — the sampler selection) rides the host invoker node
    host = res.host_sampler
    if "cfg" in host:
        kwargs.setdefault("cfg_scale", float(host["cfg"]))
    host_seed = host.get("noise_seed", host.get("seed"))
    if host_seed is not None:
        kwargs.setdefault("seed", int(host_seed))
    if sampler is None and isinstance(host.get("sampler_name"), str):
        from .functions import SAMPLERS

        name = host["sampler_name"]
        if name in SAMPLERS:
            kwargs.setdefault("sampler", SAMPLERS[name])
        else:
            res.warnings.append(
                f"host sampler_name {name!r} is not in the native "
                "registry; pipeline keeps its default sampler")
    roots = res.noise_roots
    if roots:
        nid = list(roots)[-1]
        kwargs.setdefault("noise", roots[nid])
        if len(roots) > 1:
            res.warnings.append(
                f"multiple unconsumed noise chains: pipeline uses {nid}")
    if wcfgs:
        kwargs.setdefault("wavelet_cfg", wcfgs[-1])
    # SonarApplyLatentOperationCFG builds a (patch_fn, hook) pair — wire it
    latent_ops = [res.built[nid] for nid in res.built
                  if res.classes[nid] == "SonarApplyLatentOperationCFG"]
    if latent_ops:
        kwargs.setdefault("latent_op_cfg", latent_ops[-1])
        if len(latent_ops) > 1:
            res.warnings.append(
                "multiple SonarApplyLatentOperationCFG nodes: pipeline "
                "applies only the last; chain operations into one node for "
                "combined behavior")
    pipe = SonarPipeline(model=model, model_uncond=model_uncond,
                         model_sampling=model_sampling, **kwargs)
    return pipe, res
