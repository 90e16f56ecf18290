"""EnOpt: ensemble gradient, batched line search, gradient descent
(PyTorch counterpart of `historymatching_tpu.opt.enopt`).

Objectives are batched: `obj(U)` maps controls (B, d) to values (B,), and
a conditional objective `obj_ux(U, X)` maps (B, d) and (B, dx) to (B,).
With the NPV objective one call is one `simulate` of B members, so every
function here puts all the members it can into one call: an ensemble
gradient's perturbations (both halves of StoSAG together), a line search's
trial steps, and in `gd_scan_multi` every start's perturbations, then
every start's trials. Random draws come from a `prng` key, split as the
JAX package splits its key and drawn as it draws (float32 normals, cast
to the controls' dtype), `prng.PRNGKey(0)` when no source is named; or
from a `torch.Generator`; or are given as the standard-normal `Z`.
Controls given as tensors keep their device, others go to `device` (the
card unless the caller names another). The optimisation loops run on the
host.

The robust strategies take a member-sharded uncertainty ensemble `X`
(`parallel.mesh`): each rank evaluates the conditional objective on its
own members, and `robust_mean` is the robust objective over them.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from historymatching_tpu_torch import prng
from historymatching_tpu_torch.ops.linalg import rinv_tikh
from historymatching_tpu_torch.parallel.mesh import (
    gather_members,
    local_members,
    member_mean,
    member_mesh,
    reduce_members,
)
from historymatching_tpu_torch.utils import as_float, center

XSTEPS = tuple(0.5 ** (i + 1) for i in range(8))


def _control(u, device):
    """Controls as a floating tensor: a tensor keeps its device and its
    floating dtype, anything else goes to `device`."""
    return as_float(u, device=None if isinstance(u, torch.Tensor) else device)


def _perturbations(Z, chol):
    """Centred perturbations (..., nEns, M) from standard-normal draws `Z`:
    Z L' for a Cholesky factor L (M, M), Z L for a scalar std-dev."""
    dU = Z @ chol.mT if chol.ndim == 2 else Z * chol
    return center(dU, dim=-2)[0]


def _source(key, generator, Z, device):
    """The draws' source: `key` (a `prng` key, or a `torch.Generator` in
    the key's place), else `generator`, else `prng.PRNGKey(0)` on
    `device` unless the draws `Z` are given."""
    if isinstance(key, torch.Generator):
        key, generator = None, key
    if key is None and generator is None and Z is None:
        key = prng.PRNGKey(0, device=device)
    return key, generator


def _draws(shape, u, rng, Z):
    """Standard normals `shape` in u's dtype and device: `Z`, or drawn
    from a `prng` key or a `torch.Generator`."""
    if Z is not None:
        return torch.as_tensor(Z, dtype=u.dtype, device=u.device)
    if prng.is_key(rng):
        return prng.normal(rng, shape).to(dtype=u.dtype, device=u.device)
    return torch.randn(shape, generator=rng, dtype=u.dtype, device=u.device)


def _gradient(dU, dJ, precond):
    """Ensemble gradient (..., M) from perturbations (..., nEns, M) and
    objective values (..., nEns): the preconditioned form dU' dJ / (N-1),
    or the Tikhonov least-squares form rinv(dU) dJ."""
    dJ = dJ.to(dU.dtype)
    if precond:
        return (dU.mT @ dJ[..., None])[..., 0] / (dU.shape[-2] - 1)
    return (rinv_tikh(dU, 0.1) @ dJ[..., None])[..., 0]


@dataclasses.dataclass
class EnGrad:
    """Ensemble gradient estimate: least-squares regression of objective
    values on centred Gaussian control perturbations."""

    chol: Any = 1.0  # Cholesky factor (M, M) or scalar std-dev
    nEns: int = 10
    precond: bool = False
    robustly: Optional[str] = None  # None | "naive" | "Paired" | "StoSAG" | "Mean-model" | "Fragile"
    obj_ux: Optional[Callable] = None  # conditional objective obj_ux(U, X)
    X: Any = None  # uncertainty ensemble (nX, dx), may be member-sharded

    def __call__(self, obj, u, key=None, generator=None, Z=None):
        """Gradient of `obj` at `u` (M,), the perturbations drawn from a
        `prng` `key` as the JAX package draws them (`prng.PRNGKey(0)`
        unless a source is given), or from `generator`; `Z` (nEns, M)
        replaces the draws. On a mesh every rank draws the same."""
        key, generator = _source(key, generator, Z, u.device)
        chol = torch.as_tensor(self.chol, dtype=u.dtype, device=u.device)
        Zs = _draws((self.nEns, u.shape[0]), u, key if key is not None else generator, Z)
        dU = _perturbations(Zs, chol)
        return _gradient(dU, self.ens_eval(obj, u, u + dU), self.precond)

    def ens_eval(self, obj, u, U):
        """Objective values of the perturbed controls `U` (nEns, d) under
        the robust strategy. Paired and StoSAG pair U's rows with X's, so
        they need len(X) == nEns; StoSAG subtracts obj_ux(u, X), its two
        halves evaluated as one batch. With a member-sharded X each rank
        evaluates its own rows of U with its members, and the values are
        gathered; Mean-model's mean of X is all-reduced."""
        if self.robustly in (None, "naive"):
            return obj(U)
        X = self.X
        mesh = member_mesh(X)
        if self.robustly in ("Paired", "StoSAG") and len(X) != len(U):
            raise ValueError(f"{self.robustly} pairs members: len(X) = {len(X)} != nEns = "
                             f"{len(U)}")
        if self.robustly in ("Paired", "StoSAG"):
            Xl, Ul = local_members(X, mesh), local_members(U, mesh)
            if self.robustly == "Paired":
                return gather_members(self.obj_ux(Ul, Xl), mesh)
            J = self.obj_ux(torch.cat([Ul, u.expand_as(Ul)]), torch.cat([Xl, Xl]))
            return gather_members(J[: len(Ul)] - J[len(Ul):], mesh)
        if self.robustly in ("Mean-model", "Fragile"):
            x_mean = member_mean(local_members(X, mesh), mesh)
            return self.obj_ux(U, x_mean.expand(len(U), -1))
        raise ValueError(f"Unknown robust strategy {self.robustly!r}")


def robust_mean(obj_ux, X):
    """The robust objective over the uncertainty ensemble `X` (nX, dx):
    U (B, d) -> (B,), the mean over X's members x of obj_ux(u, x) (the
    JAX package's `vmap(obj_ux, in_axes=(None, 0))(u, X).mean()`), every
    pair in one obj_ux call of B * nX rows. With a member-sharded X each
    rank evaluates its own members and the sums are all-reduced."""
    mesh = member_mesh(X)
    Xl = local_members(X, mesh)

    def obj(U):
        n = len(U)
        J = obj_ux(U.repeat_interleave(len(Xl), 0), Xl.repeat(n, 1)).reshape(n, len(Xl))
        return reduce_members(J.sum(1), mesh) / len(X)

    return obj


@dataclasses.dataclass
class Backtracker:
    """Batched backtracking line search: every trial step in one objective
    call, the first acceptable one taken (accept-first)."""

    sign: int = +1  # maximise (+1) or minimise (-1)
    xSteps: tuple = XSTEPS
    rtol: float = 1e-8

    def accept_first(self, J0, J1):
        """The accept-first rule for S searches at once: trial values J1
        (S, T) against J0 (S,), a trial acceptable where it improves on J0
        by more than max(1e-8, |J0|) rtol. Returns (any_ok (S,), the index
        of each row's first acceptable trial (S,))."""
        atol = torch.clamp_min(J0.abs(), 1e-8) * self.rtol
        ok = self.sign * (J1 - J0[:, None]) > atol[:, None]
        return ok.any(1), ok.to(torch.uint8).argmax(1)

    def __call__(self, obj, u0, J0, search_direction):
        """(u1, J1, dict(nDeclined=i)) for the first acceptable trial from
        `u0`, or None."""
        steps = torch.as_tensor(self.xSteps, dtype=u0.dtype, device=u0.device)
        U1 = u0[None, :] + self.sign * steps[:, None] * search_direction[None, :]
        J1 = obj(U1).cpu()
        any_ok, i = self.accept_first(torch.tensor([float(J0)], dtype=J1.dtype), J1[None])
        if not any_ok[0]:
            return None
        i = int(i[0])
        return U1[i], float(J1[i]), dict(nDeclined=i)


def GD(objective, u, nabla=None, line_search=None, nrmlz=True, nIter=100, key=None, quiet=True,
       callback=None, generator=None, Z=None, device="cuda"):
    """Gradient ascent or descent: per iteration one gradient batch
    (`nabla`), then one line-search batch. The gradient's draws come from
    `key`, split once an iteration as the JAX package splits it
    (`prng.PRNGKey(0)` unless a source is given), or from `generator` (also
    taken in the key's place); `Z` (nIter, nEns, M) replaces the draws of
    each iteration. `quiet` is the JAX package's: there is no progress bar
    either way. Returns (path (n+1, d), objs (n+1,), info) with info's
    `cause`, `nIter` and `nEvals` (objective evaluations: the start, then
    nEns a gradient, twice that for StoSAG, and the trials of each line
    search that ran). `callback` gets dict(iter, nIter, J, u, elapsed_s,
    accepted) after each line search.

    A zero gradient stops the run as converged; a non-finite one stops it
    with a cause of its own."""
    nabla = nabla if nabla is not None else EnGrad()
    line_search = line_search if line_search is not None else Backtracker()
    u = _control(u, device)
    key, generator = _source(key, generator, Z, u.device)
    states = [[u, float(objective(u[None])[0]), {}]]
    info = {}
    itr = n_grad = n_search = 0
    t0 = time.perf_counter()
    for itr in range(nIter):
        u_cur, J, info = states[-1]
        if Z is not None:
            grad = nabla(objective, u_cur, Z=Z[itr])
        elif key is not None:
            key, sub = prng.split(key)
            grad = nabla(objective, u_cur, sub)
        else:
            grad = nabla(objective, u_cur, generator=generator)
        n_grad += 1
        info["grad"] = grad
        if nrmlz:
            gn = float(grad.pow(2).mean().sqrt())
            if not math.isfinite(gn):
                info["cause"] = "GD stopped: non-finite gradient"
                break
            if gn == 0.0:  # a flat objective: no direction to normalize
                info["cause"] = "GD converged"
                break
            grad = grad / gn
        updated = line_search(objective, u_cur, J, grad)
        n_search += 1
        if callback is not None:
            callback(dict(iter=itr + 1, nIter=nIter, J=updated[1] if updated else J,
                          u=updated[0] if updated else u_cur,
                          elapsed_s=time.perf_counter() - t0, accepted=bool(updated)))
        if updated:
            states.append(list(updated))
        else:
            info["cause"] = "GD converged"
            break
    else:
        info["cause"] = "GD ran out of iters"
    info["nIter"] = itr
    per_grad = getattr(nabla, "nEns", 0) * (2 if getattr(nabla, "robustly", None) == "StoSAG"
                                            else 1)
    info["nEvals"] = 1 + n_grad * per_grad + n_search * len(getattr(line_search, "xSteps", ()))
    path = torch.stack([s[0] for s in states])
    objs = torch.tensor([s[1] for s in states], dtype=u.dtype, device=u.device)
    return path, objs, info


def _gd_starts(objective, U0, keys, *, chol, nEns, precond, nrmlz, nIter, sign, xSteps, rtol,
               generator, Z):
    """Multistart GD from the starts `U0` (nStart, M), start s drawing
    from the chain of `keys[s]` (split once an iteration), or every start
    from `generator`, or `Z` (nStart, nIter, nEns, M) given."""
    nS, M = U0.shape
    dt, dev = U0.dtype, U0.device
    chol = torch.as_tensor(chol, dtype=dt, device=dev)
    steps = torch.as_tensor(xSteps, dtype=dt, device=dev)
    search = Backtracker(sign=sign, xSteps=xSteps, rtol=rtol)
    Z = None if Z is None else torch.as_tensor(Z, dtype=dt, device=dev)
    keys = None if keys is None else list(keys)
    u, J = U0, objective(U0)
    done = torch.zeros(nS, dtype=torch.bool, device=dev)
    paths, objs, dones = [u], [J], []
    for it in range(nIter):
        if Z is not None:
            Zi = Z[:, it]
        elif keys is not None:
            subs = []
            for s in range(nS):
                keys[s], sub = prng.split(keys[s])
                subs.append(_draws((nEns, M), U0, sub, None))
            Zi = torch.stack(subs)
        else:
            Zi = _draws((nS, nEns, M), U0, generator, None)
        act = torch.nonzero(~done)[:, 0]
        if act.numel() == 0:
            break
        ua, Ja = u[act], J[act]
        dU = _perturbations(Zi[act], chol)
        dJ = objective((ua[:, None] + dU).reshape(-1, M)).reshape(-1, nEns)
        g = _gradient(dU, dJ, precond)
        if nrmlz:
            gn = g.pow(2).mean(-1, keepdim=True).sqrt()
            g = torch.where(gn > 0, g / torch.where(gn > 0, gn, 1.0), 0.0)
        U1 = ua[:, None] + sign * steps[:, None] * g[:, None]
        J1 = objective(U1.reshape(-1, M)).reshape(-1, len(xSteps))
        any_ok, i = search.accept_first(Ja, J1)
        pick = torch.arange(len(act), device=dev)
        u = u.index_copy(0, act, torch.where(any_ok[:, None], U1[pick, i], ua))
        J = J.index_copy(0, act, torch.where(any_ok, J1[pick, i], Ja))
        done = done.index_copy(0, act, ~any_ok)
        paths.append(u)
        objs.append(J)
        dones.append(done)
    dones += [done] * (nIter - len(dones))
    paths += [u] * (nIter + 1 - len(paths))
    objs += [J] * (nIter + 1 - len(objs))
    d = torch.stack(dones, 1).cpu().numpy() if nIter else np.zeros((nS, 0), bool)
    n_eff = np.where(d.any(axis=1), np.argmax(d, axis=1), int(nIter))
    info = dict(cause=["GD converged" if r.any() else "GD ran out of iters" for r in d],
                nIter=n_eff, nEvals=1 + (n_eff + 1) * (nEns + len(xSteps)))
    return torch.stack(paths, 1), torch.stack(objs, 1), info


def gd_scan_multi(objective, U0, *, chol=1.0, nEns=10, precond=False, nrmlz=True, nIter=100,
                  sign=+1, xSteps=None, rtol=1e-8, key=None, generator=None, Z=None,
                  device="cuda"):
    """Multistart GD, every start advancing together: per iteration one
    objective call for every start's nEns perturbations, one for every
    start's trial steps. `U0` is (nStart, M). The draws: each start its own
    key, `split(key, nStart)` as the JAX package splits it, then split once
    an iteration (`key` defaults to `prng.PRNGKey(0)`); or from `generator`;
    or `Z` (nStart, nIter, nEns, M) given. A direction of zero norm (or a
    non-finite one) is zero, so no trial is accepted.

    A start with no acceptable trial is done and frozen; done starts leave
    the batch, and the loop ends once every start is done. Returns (paths
    (nStart, nIter+1, M), objs (nStart, nIter+1), info): rows past a
    start's `nIter` repeat its final state, as the full trip count would
    give; info's `nIter` and `nEvals` are per start."""
    U0 = _control(U0, device)
    U0 = U0.reshape(1, -1) if U0.ndim < 2 else U0
    key, generator = _source(key, generator, Z, U0.device)
    keys = None if key is None else prng.split(key, U0.shape[0])
    return _gd_starts(objective, U0, keys, chol=chol, nEns=nEns, precond=precond, nrmlz=nrmlz,
                      nIter=nIter, sign=sign, xSteps=XSTEPS if xSteps is None else tuple(xSteps),
                      rtol=rtol, generator=generator, Z=Z)


def gd_scan(objective, u, *, chol=1.0, nEns=10, precond=False, nrmlz=True, nIter=100, sign=+1,
            xSteps=None, rtol=1e-8, key=None, generator=None, Z=None, device="cuda"):
    """`gd_scan_multi` of one start: the iteration of `GD` with `EnGrad`
    and `Backtracker` with the zero-direction guard, drawing from `key`
    itself, split once an iteration (`prng.PRNGKey(0)` unless a source is
    given), from `generator`, or `Z` (nIter, nEns, M) given. Returns
    (path, objs, info) trimmed to the start and its accepted steps, with
    info's `cause`, `nIter` and `nEvals`."""
    u = _control(u, device)
    key, generator = _source(key, generator, Z, u.device)
    paths, objs, info = _gd_starts(
        objective, u[None], None if key is None else [key], chol=chol, nEns=nEns,
        precond=precond, nrmlz=nrmlz, nIter=nIter, sign=sign,
        xSteps=XSTEPS if xSteps is None else tuple(xSteps), rtol=rtol, generator=generator,
        Z=None if Z is None else torch.as_tensor(Z)[None])
    n = int(info["nIter"][0])
    return (paths[0, : n + 1], objs[0, : n + 1],
            dict(cause=info["cause"][0], nIter=n, nEvals=int(info["nEvals"][0])))
