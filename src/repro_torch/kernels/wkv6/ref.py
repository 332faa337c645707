"""Plain PyTorch version of the WKV6 kernel: the step-by-step recurrence.

Counterpart of ``repro.kernels.wkv6.ref.wkv6_ref``.  Per batch·head row,
with key/value width D and a data-dependent per-channel decay
``w_t = exp(logw_t)``:

    o_t = r_t S_{t-1} + (r_t · (u ⊙ k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

Contract (also of ``csrc/wkv6.cu``): ``r``, ``k``, ``v``, ``logw``
(BH, T, D); ``u`` one bonus row per batch·head row (BH, D), or (D,) shared
by all; fp32 inside; ``o`` in r's dtype, the final state (BH, D, D) fp32.
:func:`wkv6_bwd_ref` is the plain version of the backward kernel,
``csrc/wkv6_bwd.cu``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step recurrence over (BH, T, D) from a zero state:
    ``(o (BH, T, D), final state (BH, D, D))``."""
    BH, T, D = r.shape
    w = torch.exp(logw.float())
    u = u.float()
    if u.ndim == 1:
        u = u[None].expand(BH, D)
    S = torch.zeros((BH, D, D), dtype=torch.float32, device=r.device)
    rf, kf, vf = r.float(), k.float(), v.float()
    outs = []
    for t in range(T):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], w[:, t]
        out = torch.einsum("bd,bde->be", rt, S)
        bonus = (rt * u * kt).sum(-1)
        out = out + bonus[:, None] * vt
        S = wt[:, :, None] * S + kt[:, :, None] * vt[:, None, :]
        outs.append(out)
    o = (torch.stack(outs, 1) if outs
         else torch.zeros((BH, 0, D), dtype=torch.float32, device=r.device))
    return o.to(r.dtype), S


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                 dstate: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """Plain version of ``csrc/wkv6_bwd.cu``: the gradients of
    :func:`wkv6_ref`'s outputs, given ``do`` (BH, T, D), the gradient of
    ``o``, and ``dstate`` (BH, D, D), that of the final state (None: 0).

    The explicit reverse recurrence, in fp32.  With ``G_t`` the gradient of
    ``S_t`` (``G_{T-1} = dstate``), walking t down from T - 1::

        dr_t    = S_{t-1} do_t + u ⊙ k_t (do_t · v_t)
        dk_t    = G_t v_t + r_t ⊙ u (do_t · v_t)
        dv_t    = G_tᵀ k_t + (r_t · (u ⊙ k_t)) do_t
        dlogw_t = w_t ⊙ rowsum(G_t ⊙ S_{t-1})
        du     += r_t ⊙ k_t (do_t · v_t)
        G_{t-1} = diag(w_t) G_t + r_t do_tᵀ

    Returns ``(dr, dk, dv, dlogw, du)``: dr, dk, dv in r's dtype, dlogw
    fp32, du fp32 in u's shape ((BH, D), or (D,) summed over the rows).
    Every state S_{t-1} is kept, so memory grows as T BH D²."""
    BH, T, D = r.shape
    f32 = dict(dtype=torch.float32, device=r.device)
    w = torch.exp(logw.float())
    uf = u.float()
    ur = uf[None].expand(BH, D) if u.ndim == 1 else uf
    rf, kf, vf, gf = r.float(), k.float(), v.float(), do.float()
    S = torch.zeros((BH, D, D), **f32)
    prev = []
    for t in range(T):
        prev.append(S)
        S = w[:, t, :, None] * S + kf[:, t, :, None] * vf[:, t, None, :]
    G = (torch.zeros((BH, D, D), **f32) if dstate is None
         else dstate.float())
    dr, dk, dv, dlogw = (torch.zeros((BH, T, D), **f32) for _ in range(4))
    du = torch.zeros((BH, D), **f32)
    for t in reversed(range(T)):
        rt, kt, vt, gt, wt = rf[:, t], kf[:, t], vf[:, t], gf[:, t], w[:, t]
        dov = (gt * vt).sum(-1, keepdim=True)
        rku = (rt * ur * kt).sum(-1, keepdim=True)
        dr[:, t] = torch.einsum("bij,bj->bi", prev[t], gt) + ur * kt * dov
        dk[:, t] = torch.einsum("bij,bj->bi", G, vt) + rt * ur * dov
        dv[:, t] = torch.einsum("bij,bi->bj", G, kt) + rku * gt
        dlogw[:, t] = wt * (G * prev[t]).sum(-1)
        du += rt * kt * dov
        G = wt[:, :, None] * G + rt[:, :, None] * gt[:, None, :]
    if u.ndim == 1:
        du = du.sum(0)
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlogw, du)


def wkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor, chunk: int = 32,
                     sub: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked form that ``csrc/wkv6.cu`` computes, in fp32, with its
    sub-block factoring: same contract as :func:`wkv6_ref`.

    Chunks of ``chunk`` steps (T padded with zero r, k, v and logw = 0,
    which leave the state alone), sub-blocks of ``sub`` steps.  With ``lc``
    the inclusive and ``lcp`` the exclusive cumsum of logw in the chunk,
    every exponent below is <= 0 (logw <= 0, so lc does not increase):

      rA[t]  = r[t] exp(lcp[t] - lcp[b(t)])     b(t): first step of t's block
      kE[s]  = k[s] exp(lc[e(s)] - lc[s])       e(s): last step of s's block
      A[t,s] = sum_d rA[t] mid[I(s), J(t)] kE[s]   blocks I(s) < J(t), with
               mid[I, J] = exp(lcp[b_J] - lc[e_I])
      A[t,s] = sum_d r[t] k[s] exp(min(lcp[t] - lc[s], 0))   s < t, one block
      A[t,t] = sum_d r[t] u k[t]                             the bonus
      o      = (rA exp(lcp[b])) S + A v
      S'     = exp(lc[-1]) S + (kE exp(lc[-1] - lc[e]))^T v
    """
    BH, T, D = r.shape
    dtype, L = r.dtype, chunk
    if chunk % sub or sub < 1:
        raise ValueError(f"chunk {chunk} is no multiple of sub {sub}")
    dev = r.device
    f32 = dict(dtype=torch.float32, device=dev)
    u = u.float()
    if u.ndim == 1:
        u = u[None].expand(BH, D)
    pad = (-T) % L
    r, k, v, lw = (torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
                   for x in (r, k, v, logw))
    step = torch.arange(L, device=dev)
    blk = step // sub                                   # J(t), I(s)
    first, last = blk * sub, blk * sub + sub - 1        # b(t), e(s)
    later = blk[:, None] > blk[None, :]                 # J(t) > I(s)
    same = (blk[:, None] == blk[None, :]) & (step[:, None] > step[None, :])
    S = torch.zeros((BH, D, D), **f32)
    outs = []
    for c0 in range(0, T + pad, L):
        rc, kc, vc, lwc = (x[:, c0:c0 + L] for x in (r, k, v, lw))
        lc = torch.cumsum(lwc, 1)
        lcp = torch.cat([torch.zeros((BH, 1, D), **f32), lc[:, :-1]], 1)
        lcp_b, lc_e = lcp[:, ::sub], lc[:, sub - 1::sub]     # (BH, nb, D)
        rA = rc * torch.exp(lcp - lcp[:, first])
        kE = kc * torch.exp(lc[:, last] - lc)
        mid = torch.exp(torch.clamp(lcp_b[:, None] - lc_e[:, :, None],
                                    max=0.0))            # (BH, I, J, D)
        mid_ts = mid[:, blk][:, :, blk].transpose(1, 2)  # (BH, t, s, D)
        A = torch.einsum("btd,btsd,bsd->bts", rA, mid_ts, kE) * later
        e = torch.exp(torch.clamp(lcp[:, :, None] - lc[:, None], max=0.0))
        A = A + torch.einsum("btd,bsd,btsd->bts", rc, kc, e) * same
        A = A + torch.diag_embed((rc * u[:, None] * kc).sum(-1))
        o = (rA * torch.exp(lcp_b)[:, blk]) @ S + A @ vc
        kS = kE * torch.exp(lc[:, -1:] - lc_e)[:, blk]
        S = torch.exp(lc[:, -1])[:, :, None] * S + kS.transpose(1, 2) @ vc
        outs.append(o)
    o = (torch.cat(outs, 1)[:, :T] if outs
         else torch.zeros((BH, 0, D), **f32))
    return o.to(dtype), S


def wkv6_bwd_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         logw: torch.Tensor, u: torch.Tensor,
                         do: torch.Tensor,
                         dstate: Optional[torch.Tensor] = None,
                         chunk: int = 32, sub: int = 8
                         ) -> Tuple[torch.Tensor, ...]:
    """The chunked backward that ``csrc/wkv6_bwd.cu`` computes, in fp32,
    with the factoring of :func:`wkv6_chunked_ref`: same contract as
    :func:`wkv6_bwd_ref`.

    Three stages, as the kernel runs them:

    1. the state at every chunk's start, ``S_0 = 0``, ``S_{c+1} =
       exp(lc[-1]) S_c + kS^T v`` (the forward's update);
    2. the state's gradient at every chunk's end, ``G_{nc-1} = dstate``
       (or 0), ``G_{c-1} = exp(lc[-1]) G_c + (r exp(lcp))^T do`` over
       chunk c: the only reverse carry;
    3. every chunk on its own, from ``S_c``, ``S_{c+1}`` and ``G_c``, with
       ``B = do v^T`` and the forward's ``A`` (bonus on its diagonal)::

         drs = exp(lcp) (do S_c^T),  dks = exp(lc[-1] - lc) (v G_c^T)
         drf = drs + rdec sum_{I<J} mid[I,J] B[:,I] kE[I]
               + the diagonal sub-blocks, pairs two or more steps apart
         dkf = kdec sum_{J>I} mid[I,J] B[J,:]^T rA[J] + the same
         dr = drf + B[t,t-1] k[t-1] + u k dov
         dk = dks + dkf + B[t+1,t] r[t+1] + r u dov
         dv = kS G_c + A^T do
         dlogw[t] = exp(lc[-1]) rowsum(G_c S_c) + sum_{s>t} r drf[s]
                    + sum_{s<t} k dks[s] - sum_{s>=t} k dkf[s]

       (``rdec = exp(lcp - lcp[b])`` and ``kdec = exp(lc[e] - lc)``, so
       ``rA = r rdec``, ``kE = k kdec``; ``dov = diag(B)``; the
       off-diagonal sums leave out the one adjacent pair across a block
       boundary.)  dlogw[t] = w_t rowsum(G_t S_{t-1}), expanded over the
       chunk's state and steps: every term in it carries the decays
       between its two steps, so under strong decays no sum of order 1 is
       subtracted from another (the chunk's reverse cumsum of ``r dr - k
       dk`` would subtract the adjacent pairs' and the bonus's terms).

    Every exponent is a difference of cumsums that is <= 0; lcp is the
    exclusive cumsum itself, never ``lc - logw``.  T is padded to the chunk
    with zero r, k, v, do and logw = 0, which change nothing."""
    BH, T, D = r.shape
    if chunk % sub or sub < 1:
        raise ValueError(f"chunk {chunk} is no multiple of sub {sub}")
    L, dev = chunk, r.device
    f32 = dict(dtype=torch.float32, device=dev)
    ur = u.float()
    if ur.ndim == 1:
        ur = ur[None].expand(BH, D)
    pad = (-T) % L
    rp, kp, vp, lw, gp = (torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
                          for x in (r, k, v, logw, do))
    nc = (T + pad) // L
    step = torch.arange(L, device=dev)
    blk = step // sub
    first, last = blk * sub, blk * sub + sub - 1
    later = (blk[:, None] > blk[None, :]).float()          # J(t) > I(s)
    same = ((blk[:, None] == blk[None, :])
            & (step[:, None] > step[None, :])).float()      # s < t, one block

    def chunk_terms(c):
        sl = slice(c * L, (c + 1) * L)
        lwc = lw[:, sl]
        lc = torch.cumsum(lwc, 1)
        lcp = torch.cat([torch.zeros((BH, 1, D), **f32), lc[:, :-1]], 1)
        lcp_b, lc_e, lcL = lcp[:, ::sub], lc[:, sub - 1::sub], lc[:, -1]
        rdec = torch.exp(lcp - lcp[:, first])
        kdec = torch.exp(lc[:, last] - lc)
        gJ = torch.exp(lcp_b)[:, blk]                 # exp(lcp[b(t)])
        hI = torch.exp(lcL[:, None] - lc_e)[:, blk]   # exp(lc[-1] - lc[e(t)])
        mid = torch.exp(torch.clamp(lcp_b[:, None] - lc_e[:, :, None],
                                    max=0.0))         # (BH, I, J, D)
        return dict(sl=sl, lc=lc, lcp=lcp, rdec=rdec, kdec=kdec, gJ=gJ, hI=hI,
                    mid_ts=mid[:, blk][:, :, blk].transpose(1, 2),
                    wL=torch.exp(lcL))

    terms = [chunk_terms(c) for c in range(nc)]
    # ---- 1. chunk-start states
    S = [torch.zeros((BH, D, D), **f32)]
    for c, x in enumerate(terms):
        kS = kp[:, x["sl"]] * x["kdec"] * x["hI"]
        S.append(x["wL"][:, :, None] * S[-1]
                 + kS.transpose(1, 2) @ vp[:, x["sl"]])
    # ---- 2. the reverse carry of the state's gradient
    G = [None] * nc
    G[-1] = (torch.zeros((BH, D, D), **f32) if dstate is None
             else dstate.float().reshape(BH, D, D))
    for c in range(nc - 1, 0, -1):
        x = terms[c]
        rg = rp[:, x["sl"]] * x["rdec"] * x["gJ"]
        G[c - 1] = (x["wL"][:, :, None] * G[c]
                    + rg.transpose(1, 2) @ gp[:, x["sl"]])
    # ---- 3. every chunk on its own
    far = (step[:, None] - step[None, :] >= 2).float()      # s <= t - 2
    adj = (step[:, None] - step[None, :] == 1).float()      # s == t - 1
    dr, dk, dv, dlogw = (torch.zeros((BH, nc * L, D), **f32)
                         for _ in range(4))
    du = torch.zeros((BH, D), **f32)
    for c, x in enumerate(terms):
        sl = x["sl"]
        rc, kc, vc, gc = rp[:, sl], kp[:, sl], vp[:, sl], gp[:, sl]
        lc, lcp, mid_ts = x["lc"], x["lcp"], x["mid_ts"]
        rA, kE = rc * x["rdec"], kc * x["kdec"]
        B = gc @ vc.transpose(1, 2)                       # B[t, s] = do_t v_s
        dov = torch.diagonal(B, dim1=1, dim2=2)[..., None]
        # e[t, s] = exp(min(lcp[t] - lc[s], 0)): the diagonal sub-blocks
        e = torch.exp(torch.clamp(lcp[:, :, None] - lc[:, None], max=0.0))
        A = torch.einsum("btd,btsd,bsd->bts", rA, mid_ts, kE) * later
        A = A + torch.einsum("btd,bsd,btsd->bts", rc, kc, e) * same
        A = A + torch.diag_embed((rc * ur[:, None] * kc).sum(-1))
        # the state terms; the pairs two or more steps apart (factored
        # through the sub-blocks across blocks); the adjacent pairs, whose
        # decay exp(lcp[t] - lc[t-1]) is 1; the bonus
        drs = x["rdec"] * x["gJ"] * (gc @ S[c].transpose(1, 2))
        dks = x["kdec"] * x["hI"] * (vc @ G[c].transpose(1, 2))
        bl, bs = B * later * far, B * same * far
        drf = (drs + x["rdec"] * torch.einsum("bts,btsd,bsd->btd",
                                              bl, mid_ts, kE)
               + torch.einsum("bts,bsd,btsd->btd", bs, kc, e))
        dkf = (x["kdec"] * torch.einsum("bst,bstd,bsd->btd", bl, mid_ts, rA)
               + torch.einsum("bst,bsd,bstd->btd", bs, rc, e))
        drc = (drf + torch.einsum("bts,bsd->btd", B * adj, kc)
               + ur[:, None] * kc * dov)
        dkc = (dks + dkf + torch.einsum("bst,bsd->btd", B * adj, rc)
               + rc * ur[:, None] * dov)
        kS = kc * x["kdec"] * x["hI"]
        dvc = kS @ G[c] + A.transpose(1, 2) @ gc
        # dlogw[t] = w_t rowsum(G_t S_{t-1}) = exp(lc[-1]) rowsum(G_c S_c)
        #   + sum_{s>t} r drf[s] + sum_{s<t} k dks[s] - sum_{s>=t} k dkf[s]
        # (the adjacent pairs and the bonus cancel out of it exactly, so no
        # term of order 1 is subtracted from another under strong decay)
        qg = x["wL"] * (G[c] * S[c]).sum(-1)              # (BH, D)
        zero = torch.zeros((BH, 1, D), **f32)
        ra = torch.flip(torch.cumsum(torch.flip(rc * drf, [1]), 1), [1])
        kb = torch.cumsum(kc * dks, 1)
        kf = torch.flip(torch.cumsum(torch.flip(kc * dkf, [1]), 1), [1])
        dlogw[:, sl] = (qg[:, None] + torch.cat([ra[:, 1:], zero], 1)
                        + torch.cat([zero, kb[:, :-1]], 1) - kf)
        dr[:, sl], dk[:, sl], dv[:, sl] = drc, dkc, dvc
        du += (rc * kc * dov).sum(1)
    if u.ndim == 1:
        du = du.sum(0)
    return (dr[:, :T].to(r.dtype), dk[:, :T].to(k.dtype),
            dv[:, :T].to(v.dtype), dlogw[:, :T], du)
