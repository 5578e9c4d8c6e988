"""Coefficient-table multistep samplers (port of
``sonar_tpu.samplers.multistep``): deis / lms / ipndm / ipndm_v / uni_pc under
their ComfyUI registry names.

Every solver coefficient (the Lagrange-basis integrals of deis/lms/ipndm_v,
the Adams-Bashforth table of ipndm, the UniPC R/b systems and rho solves)
depends only on the sigma schedule, so it is computed once a run in float64
numpy on the host, as in the JAX package, and rounded to float32 where the
JAX package rounds it. A step is one model call plus one linear combination
of the history buffer with host-number weights; a weight that is 0 (the
warm-up steps, the final-step order drop) adds no term.

Algorithm sources (re-derived in the JAX package, copied here):
- DEIS t-AB: arXiv:2204.13902 (exact polynomial integrals of the Lagrange
  basis over each step in sigma space; order 1 on the final step to 0).
- LMS: k-diffusion ``sample_lms``, the same integrals at order 4 in closed
  form (k-diffusion evaluates them by quadrature).
- iPNDM: the fixed Adams-Bashforth ladder (55,-59,37,-9)/24.
- iPNDM_v: the variable-step Adams-Bashforth ladder, which is the
  Lagrange-basis integrals again.
- UniPC: arXiv:2302.04867 as ComfyUI drives it (VP schedule alpha =
  1/sqrt(1+sigma^2), lambda = -log sigma, predict_x0, bh1/bh2, order
  min(3, steps-1), lower_order_final, no corrector on the final step, a
  final sigma 0 replaced by 0.001).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .ancestral import to_d
from .momentum import SonarConfig
from .sonar import _host_sigmas, _run_loop, _setup, sharded

__all__ = [
    "sample_deis",
    "sample_lms",
    "sample_ipndm",
    "sample_ipndm_v",
    "sample_uni_pc",
    "sample_uni_pc_bh2",
    "MULTISTEP_SAMPLERS",
]


def _concrete_sigmas(sigmas) -> np.ndarray:
    """The float32 schedule on the host, in float64 for the tables."""
    return _host_sigmas(sigmas).numpy().astype(np.float64)


def _lagrange_integrals(nodes, start, end):
    """Exact ``integral_start^end`` of each Lagrange basis polynomial over
    ``nodes`` (float64 polynomial integration: the closed form of the
    k-diffusion ``linear_multistep_coeff`` quadrature)."""
    out = []
    for j in range(len(nodes)):
        poly = np.poly1d([1.0])
        denom = 1.0
        for k in range(len(nodes)):
            if k == j:
                continue
            poly = poly * np.poly1d([1.0, -nodes[k]])
            denom *= nodes[j] - nodes[k]
        prim = poly.integ()
        out.append((prim(end) - prim(start)) / denom)
    return out


_AB_FIXED = {  # classic Adams-Bashforth weights (ipndm)
    1: [1.0],
    2: [3.0 / 2.0, -1.0 / 2.0],
    3: [23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0],
    4: [55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0],
}


def _d_coeff_table(sig: np.ndarray, max_order: int, mode: str) -> np.ndarray:
    """(n_steps, max_order) weights on [d_cur, d_prev1, ...] so that
    ``x_next = x + sum_k w_k d_k``. ``mode``: 'deis' (Lagrange, order 1 on
    the final step to 0), 'lagrange' (lms/ipndm_v: Lagrange, no drop),
    'fixed' (ipndm: classic AB scaled by the step)."""
    n = len(sig) - 1
    table = np.zeros((n, max_order), np.float64)
    for i in range(n):
        order = min(i + 1, max_order)
        t_cur, t_next = sig[i], sig[i + 1]
        if mode == "deis" and t_next <= 0:
            order = 1
        if mode == "fixed":
            table[i, :order] = np.asarray(_AB_FIXED[order]) * (t_next - t_cur)
        else:
            nodes = sig[i - order + 1:i + 1][::-1]  # [t_cur, t_prev1, ...]
            table[i, :order] = _lagrange_integrals(nodes, t_cur, t_next)
    return table


def _run_d_multistep(model, x, sig, table, *, n_hist, seed, extra_args, callback, method,
                     resume_from, start_step, stop_step, return_state):
    sig32 = sig.astype(np.float32)
    st = _setup(model, x, torch.from_numpy(sig32), cfg=SonarConfig(),
                default_noise_type="gaussian", noise_item=None, noise_sampler=None, seed=seed,
                extra_args=extra_args, need_noise=False)
    coeffs = table.astype(np.float32).tolist()
    wide = torch.promote_types(x.dtype, torch.float32)

    def step_fn(carry, i):
        xc, hist, nstate = carry
        sigma = float(sig32[i])
        denoised = st.model_fn(xc, sigma)
        xw = xc.to(wide)
        d = to_d(xw, sigma, denoised.to(wide))
        c = coeffs[i]
        out = xw + d * c[0]
        for k in range(n_hist):
            if c[k + 1]:
                out = out + hist[k].to(wide) * c[k + 1]
        new_hist = (d,) + hist[:-1] if n_hist else hist
        return (out, new_hist, nstate), {"x": out, "sigma": sigma, "sigma_hat": sigma,
                                         "denoised": denoised}

    hist0 = tuple(torch.zeros_like(x) for _ in range(n_hist))
    return _run_loop(step_fn, x, len(sig32) - 1, hist0, (), callback=callback, method=method,
                     resume_from=resume_from, start_step=start_step, stop_step=stop_step,
                     return_state=return_state)


def _make_d_sampler(name: str, max_order_default: int, mode: str, doc: str) -> Callable:
    def sampler(model, x, sigmas, *, max_order: int = max_order_default, seed=None,
                extra_args=None, callback=None, method: str = "scan", resume_from=None,
                start_step: int = 0, stop_step=None, return_state: bool = False):
        if not 1 <= max_order <= 4:
            raise ValueError(f"max_order must be in 1..4, got {max_order}")
        sig = _concrete_sigmas(sigmas)
        table = _d_coeff_table(sig, max_order, mode)
        return _run_d_multistep(
            model, x, sig, table, n_hist=max_order - 1, seed=seed, extra_args=extra_args,
            callback=callback, method=method, resume_from=resume_from,
            start_step=start_step, stop_step=stop_step, return_state=return_state)

    sampler.__name__ = name
    sampler.__qualname__ = name
    sampler.__doc__ = doc
    return sharded(sampler)


sample_deis = _make_d_sampler(
    "sample_deis", 3, "deis",
    "ComfyUI ``sample_deis`` (DEIS t-AB, arXiv:2204.13902): multistep over d = "
    "(x - denoised)/sigma with exact Lagrange-basis integral coefficients in sigma "
    "space; order 1 on the final step to sigma 0.")
sample_lms = _make_d_sampler(
    "sample_lms", 4, "lagrange",
    "k-diffusion ``sample_lms``: classic 4th-order linear multistep; coefficients are "
    "the closed-form Lagrange-basis integrals the reference evaluates by quadrature.")
sample_ipndm = _make_d_sampler(
    "sample_ipndm", 4, "fixed",
    "ComfyUI ``sample_ipndm``: improved PNDM, the fixed-coefficient Adams-Bashforth "
    "ladder (55,-59,37,-9)/24 on d, scaled by the step.")
sample_ipndm_v = _make_d_sampler(
    "sample_ipndm_v", 4, "lagrange",
    "ComfyUI ``sample_ipndm_v``: the variable-step Adams-Bashforth ladder, which is "
    "the Lagrange-basis integrals (the integrated interpolating polynomial).")


# ---------------------------------------------------------------------------
# UniPC (arXiv:2302.04867) in ComfyUI's SigmaConvert parameterization.
# ---------------------------------------------------------------------------

def _unipc_tables(sig: np.ndarray, variant: str):
    """Static per-step weight rows for the UniPC predictor-corrector.

    Row layout: [r_x, c0, p1, p2, c1, c2, ct, sigma_call, inv_alpha] with the
    vp-space update
      x_base = r_x * x + c0 * m0
      x_pred = x_base + p1 (m1 - m0) + p2 (m2 - m0)
      m_new  = denoised(model, x_pred * inv_alpha, sigma_call)
      x_next = x_base + c1 (m1 - m0) + c2 (m2 - m0) + ct (m_new - m0)
    where m are EDM denoised values (the vp-space x0 predictions under alpha =
    1/sqrt(1+sigma^2)). On the final step the corrector weights equal the
    predictor's (use_corrector=False) and the model call is the reference's
    trailing evaluation."""
    ts = sig.copy()
    if ts[-1] == 0:
        ts[-1] = 0.001  # the reference's final-sigma replacement
    lam = -np.log(ts)
    alpha = 1.0 / np.sqrt(1.0 + ts**2)
    sig_vp = ts / np.sqrt(1.0 + ts**2)
    steps = len(ts) - 1
    order_cap = max(1, min(3, steps - 1))
    rows = []
    for step in range(1, steps + 1):
        if step < order_cap:
            order = step  # init phase: lower-order warmup
        else:
            order = min(order_cap, steps + 1 - step)  # lower_order_final
        use_corrector = step != steps
        h = lam[step] - lam[step - 1]
        hh = -h  # predict_x0
        h_phi_1 = np.expm1(hh)
        B_h = hh if variant == "bh1" else np.expm1(hh)
        # rks / b ladder (reference's loop, order entries)
        rks = []
        for k in range(1, order):
            rks.append((lam[step - 1 - k] - lam[step - 1]) / h)
        rks.append(1.0)
        rks = np.asarray(rks, np.float64)
        b = []
        h_phi_k = h_phi_1 / hh - 1.0
        fact = 1.0
        for k in range(1, order + 1):
            b.append(h_phi_k * fact / B_h)
            fact *= k + 1
            h_phi_k = h_phi_k / hh - 1.0 / fact
        b = np.asarray(b, np.float64)
        R = np.stack([rks ** k for k in range(order)])
        # predictor rhos (on D1s, length order-1)
        if order == 2:
            rhos_p = np.asarray([0.5])
        elif order > 2:
            rhos_p = np.linalg.solve(R[:-1, :-1], b[:-1])
        else:
            rhos_p = np.zeros(0)
        # corrector rhos (length order; last entry weights D1_t)
        if order == 1:
            rhos_c = np.asarray([0.5])
        else:
            rhos_c = np.linalg.solve(R, b)
        r_x = sig_vp[step] / sig_vp[step - 1]
        c0 = -alpha[step] * h_phi_1
        scale = -alpha[step] * B_h
        p = np.zeros(2)
        c = np.zeros(2)
        for k in range(order - 1):  # fold 1/rk into the (m_k - m0) weight
            p[k] = scale * rhos_p[k] / rks[k] if k < len(rhos_p) else 0.0
            c[k] = scale * rhos_c[k] / rks[k]
        ct = scale * rhos_c[-1] if order >= 1 else 0.0
        if not use_corrector:
            c = p.copy()
            ct = 0.0
        rows.append([r_x, c0, p[0], p[1], c[0], c[1], ct,
                     ts[step], np.sqrt(1.0 + ts[step] ** 2)])
    return np.asarray(rows, np.float64), ts


def _uni_pc(model, x, sigmas, *, variant: str, seed=None, extra_args=None, callback=None,
            method: str = "scan", resume_from=None, start_step: int = 0, stop_step=None,
            return_state: bool = False):
    sig = _concrete_sigmas(sigmas)
    table_np, ts = _unipc_tables(sig, variant)
    rows = table_np.astype(np.float32).tolist()
    ts32 = ts.astype(np.float32)
    st = _setup(model, x, torch.from_numpy(ts32), cfg=SonarConfig(),
                default_noise_type="gaussian", noise_item=None, noise_sampler=None, seed=seed,
                extra_args=extra_args, need_noise=False)
    wide = torch.promote_types(x.dtype, torch.float32)
    alpha0 = 1.0 / float(np.sqrt(1.0 + ts[0] ** 2))
    inv_alpha_last = float(np.sqrt(1.0 + ts[-1] ** 2))

    def combine(base, terms):
        # base + w1 * (m1 - m0) + ..., left to right; a 0 weight adds nothing
        for w, a, b in terms:
            if w:
                base = base + (a - b) * w
        return base

    def step_fn(carry, i):
        x_vp, (m0, m1, m2), nstate = carry
        r = rows[i]
        m0w, m1w, m2w = (m.to(wide) for m in (m0, m1, m2))
        x_base = x_vp.to(wide) * r[0] + m0w * r[1]
        x_pred = combine(x_base, ((r[2], m1w, m0w), (r[3], m2w, m0w)))
        denoised = st.model_fn(x_pred * r[8], r[7])
        out = combine(x_base, ((r[4], m1w, m0w), (r[5], m2w, m0w),
                               (r[6], denoised.to(wide), m0w)))
        return (out, (denoised, m0, m1), nstate), {
            "x": out, "sigma": r[7], "sigma_hat": r[7], "denoised": denoised}

    # the model at sigma_0 in EDM space, then the vp-space loop; a resumed run
    # carries its history, so it needs no first evaluation
    aux0 = None if resume_from is not None else (
        st.model_fn(x, float(ts32[0])), torch.zeros_like(x), torch.zeros_like(x))
    out = _run_loop(step_fn, x * alpha0, len(ts32) - 1, aux0, (), callback=callback,
                    method=method, resume_from=resume_from, start_step=start_step,
                    stop_step=stop_step, return_state=return_state)
    if return_state:
        x_final, carry = out
        return x_final * inv_alpha_last, carry
    return out * inv_alpha_last


@sharded
def sample_uni_pc(model, x, sigmas, *, seed=None, extra_args=None, callback=None,
                  method="scan", resume_from=None, start_step=0, stop_step=None,
                  return_state=False):
    """ComfyUI ``uni_pc`` (UniPC multistep predictor-corrector, variant bh1).
    Deterministic: it takes no noise/eta knobs, so SonarPipeline's forwarding
    filter ignores a configured noise item, as the reference's uni_pc does."""
    return _uni_pc(model, x, sigmas, variant="bh1", seed=seed, extra_args=extra_args,
                   callback=callback, method=method, resume_from=resume_from,
                   start_step=start_step, stop_step=stop_step, return_state=return_state)


@sharded
def sample_uni_pc_bh2(model, x, sigmas, *, seed=None, extra_args=None, callback=None,
                      method="scan", resume_from=None, start_step=0, stop_step=None,
                      return_state=False):
    """ComfyUI ``uni_pc_bh2`` (B(h) = expm1(h) variant)."""
    return _uni_pc(model, x, sigmas, variant="bh2", seed=seed, extra_args=extra_args,
                   callback=callback, method=method, resume_from=resume_from,
                   start_step=start_step, stop_step=stop_step, return_state=return_state)


MULTISTEP_SAMPLERS = {
    "deis": sample_deis,
    "lms": sample_lms,
    "ipndm": sample_ipndm,
    "ipndm_v": sample_ipndm_v,
    "uni_pc": sample_uni_pc,
    "uni_pc_bh2": sample_uni_pc_bh2,
}

# every sampler here derives its tables from the schedule on the host (the
# JAX package's pipeline hands these a concrete schedule under jit; the port's
# pipeline always holds one)
for _fn in MULTISTEP_SAMPLERS.values():
    _fn._needs_host_sigmas = True
