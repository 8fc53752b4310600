"""Geometric-multigrid V-cycle preconditioner (the reference's
``repro/solvers/mg.py``), on one device or sharded over the ranks of a
``Comm``.

The GMG stand-in for the paper's AMG: a stencil V-cycle on
``gamma*C + diag(D)`` -- the 5-point kappa-weighted stencil with face
coefficients precomputed per level on the host, weighted-Jacobi smoothing,
full-weighting restriction and piecewise-constant prolongation, zero rows
and columns at the domain boundary (the volume constraint's Dirichlet
condition).  Every operation is a device-side tensor op with static
shapes, so a single-device V-cycle is captured into the solver's CUDA
graph whole.

Sharded (``p > 1``, DESIGN.md §7): the grid is split into contiguous
**row strips** ([n, n] -> [n/p, n] per rank), matching the flat-vector
sharding of the Krylov state; ``mg_local_shard`` cuts a rank's strips from
the stacked build (the counterpart of ``mg_specs``).  A stencil
application needs a one-row halo of ``u`` from each strip neighbour (two
``ppermute``s; zero rows at the domain's edges).  Restriction and
prolongation stay local while a strip keeps an even number of rows (level
``l`` stays sharded iff ``n_l % 2p == 0``); below that the coarse grid is
gathered to every rank and the tail of the V-cycle runs replicated.  A
grid too coarse to shard even level 0 is gathered whole.  ``fused``
(DESIGN.md §12) smooths the sharded levels on ``nu``-row-extended strips
(``_smooth_deep``): one exchange of ``b`` before the pre-smooth and one of
``u`` before the post-smooth replace the per-sweep halos, bitwise equal;
``bf16`` rounds those smoothing halos to bfloat16 on the wire.
``mg_halo_bytes`` models the bytes a rank receives per application,
``solver_hide_flops`` the solver work outside the H^2 matvec.

The halo permutes are cyclic: every rank receives from both neighbours,
and a rank at the domain's edge zeroes what wrapped around, so each rank
receives the bytes ``mg_halo_bytes`` models.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.obs.trace import phase


@dataclasses.dataclass(frozen=True)
class GridMG:
    """Static V-cycle description (shapes, schedule, scalars)."""
    n: int
    p: int
    levels: Tuple[int, ...]          # grid side per level (n, n/2, ..., 4)
    hs: Tuple[float, ...]
    n_sharded: int                   # leading levels kept in strip layout
    gamma: float
    nu: int = 3
    omega: float = 0.7
    n_cycles: int = 2

    def sharded(self, l: int) -> bool:
        return self.p > 1 and l < self.n_sharded


@dataclasses.dataclass
class MGArrays:
    """Per-level stencil data, device tensors ``[n_l, n_l]`` (a rank's
    ``[n_l/p, n_l]`` strips on sharded levels after ``mg_local_shard``)."""
    ke: List[torch.Tensor]           # face coefficients
    kw: List[torch.Tensor]
    kn: List[torch.Tensor]
    ks: List[torch.Tensor]
    dd: List[torch.Tensor]           # restricted diag(D)
    jd: List[torch.Tensor]           # Jacobi diagonal gamma*ksum/h^2 + dd
    #: per SHARDED level, the nu-row-extended coefficient strips feeding
    #: the fused deep-halo smoother (``_smooth_deep``): stacked
    #: [p*(n_l/p + 2*nu), 6, n_l] with field order (ke, kw, kn, ks, dd,
    #: jd); out-of-domain ghost coefficients are 0 (jd ghost 1) so ghost
    #: updates stay exactly +0.0.  Empty at p == 1.
    hc: List[torch.Tensor] = dataclasses.field(default_factory=list)


FIELDS = ("ke", "kw", "kn", "ks", "dd", "jd")


def _restrict_np(r: np.ndarray) -> np.ndarray:
    return 0.25 * (r[0::2, 0::2] + r[1::2, 0::2] + r[0::2, 1::2]
                   + r[1::2, 1::2])


def stencil_faces(k: np.ndarray):
    """Edge-padded face-averaged diffusivity coefficients of the 5-point
    ``-div kappa grad`` stencil (neighbor order: row+1, row-1, col+1,
    col-1)."""
    kp = np.pad(k, 1, mode="edge")
    ke = 0.5 * (kp[1:-1, 1:-1] + kp[2:, 1:-1])
    kw = 0.5 * (kp[1:-1, 1:-1] + kp[:-2, 1:-1])
    kn = 0.5 * (kp[1:-1, 1:-1] + kp[1:-1, 2:])
    ks = 0.5 * (kp[1:-1, 1:-1] + kp[1:-1, :-2])
    return ke, kw, kn, ks


def _host_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def build_grid_mg(kappa, d_diag, gamma: float, h0: float, n: int, p: int = 1,
                  nu: int = 3, omega: float = 0.7, n_cycles: int = 2,
                  device="cuda") -> Tuple[GridMG, MGArrays]:
    """Host-side pyramid build: restrict kappa/diag(D), precompute faces,
    then move every level to ``device``.

    ``kappa``/``d_diag``: [n, n] grid-order arrays (tensors or numpy).
    ``p > 1`` requires ``n % p == 0`` (row-strip layout) and adds the
    extended coefficient strips ``hc`` of the sharded levels.
    """
    if p > 1 and n % p != 0:
        raise ValueError(f"grid side {n} not divisible by p={p}")
    device = torch.device(device)
    k = _host_f32(kappa)
    d = _host_f32(d_diag)
    levels, hs = [], []
    fields_np = []                   # per level (ke, kw, kn, ks, dd, jd)
    arrs = MGArrays([], [], [], [], [], [])

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    nn, hh = n, h0
    while nn >= 4:
        ke, kw, kn, ks = stencil_faces(k)
        jd = gamma * (ke + kw + kn + ks) / (hh * hh) + d
        for name, a in zip(FIELDS, (ke, kw, kn, ks, d, jd)):
            getattr(arrs, name).append(dev(a))
        fields_np.append((ke, kw, kn, ks, d, jd))
        levels.append(nn)
        hs.append(hh)
        k = _restrict_np(k)
        d = _restrict_np(d)
        nn //= 2
        hh *= 2
    n_sharded = 0
    if p > 1:
        for n_l in levels:
            if n_l % (2 * p) != 0:
                break
            n_sharded += 1
        # nu-row-extended coefficient strips for the fused deep-halo
        # smoother: out-of-domain ghosts get zero face/diag coefficients
        # and a unit Jacobi diagonal, so a ghost row's update is exactly
        # ``u + omega*(b_ext - 0)/1`` -- +0.0 whenever its b/u ghosts are
        # zero, reproducing the Dirichlet zero-fill of ``_halo_rows_k``
        for l in range(n_sharded):
            rows = levels[l] // p
            padded = [np.pad(f, ((nu, nu), (0, 0)),
                             constant_values=1.0 if i == 5 else 0.0)
                      for i, f in enumerate(fields_np[l])]
            stacked = np.stack(padded, axis=1)   # [n_l + 2nu, 6, n_l]
            arrs.hc.append(dev(np.concatenate(
                [stacked[q * rows:q * rows + rows + 2 * nu]
                 for q in range(p)], axis=0)))
    mg = GridMG(n=n, p=p, levels=tuple(levels), hs=tuple(hs),
                n_sharded=n_sharded, gamma=gamma, nu=nu, omega=omega,
                n_cycles=n_cycles)
    return mg, arrs


def mg_local_shard(mg: GridMG, a: MGArrays, rank: int) -> MGArrays:
    """Rank ``rank``'s views of the stacked arrays (no copies): the sharded
    levels' fields and ``hc`` cut to the rank's strip, the replicated
    tail whole (the counterpart of the reference's ``mg_specs``)."""
    def cut(t: torch.Tensor) -> torch.Tensor:
        rows = t.shape[0] // mg.p
        return t[rank * rows:(rank + 1) * rows]

    out = {name: [cut(t) if mg.sharded(l) else t
                  for l, t in enumerate(getattr(a, name))]
           for name in FIELDS}
    return MGArrays(**out, hc=[cut(t) for t in a.hc])


# ---------------------------------------------------------------------------
# device-side V-cycle
# ---------------------------------------------------------------------------

def _halo_rows_k(u: torch.Tensor, comm, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``k``-row halo from the strip neighbours (zeros at the domain's
    edges).

    ``k`` may exceed the strip height: hop ``j`` fetches from the
    neighbour ``j`` strips away with one ``ppermute`` each way (all issued
    before the first wait).  Row order is global top-to-bottom.  The
    permutes are cyclic, and a rank zeroes the rows that wrapped around
    the domain's edge (module docstring); a hop beyond the domain (``j >=
    p``) ships nothing and is zero."""
    rows, p, me = u.shape[0], comm.p, comm.rank
    tops, bots = [], []
    with phase("mg/halo"):
        hops = []
        j = -(-k // rows)                   # farthest hop first (top halo)
        while j > 0:
            t = min(k - (j - 1) * rows, rows)   # rows owed by hop j
            if j >= p:
                hops.append((j, t, None, None))
            else:
                hops.append((j, t, comm.ppermute_async(
                    u[rows - t:], [(s, (s + j) % p) for s in range(p)],
                    tag=2 * j), comm.ppermute_async(
                    u[:t], [(s, (s - j) % p) for s in range(p)],
                    tag=2 * j + 1)))
            j -= 1
        for j, t, top, bot in hops:
            z = u.new_zeros((t,) + tuple(u.shape[1:]))
            top = top.wait() if top is not None else z
            bot = bot.wait() if bot is not None else z
            tops.append(top if me - j >= 0 else z)
            bots.append(bot if me + j < p else z)
    top = torch.cat(tops, dim=0) if len(tops) > 1 else tops[0]
    bot = torch.cat(bots[::-1], dim=0) if len(bots) > 1 else bots[0]
    return top, bot


def _apply_op(mg: GridMG, a: MGArrays, l: int, u: torch.Tensor, comm=None,
              halo=None) -> torch.Tensor:
    """(gamma*C + diag(D)) u on level ``l`` (strip or replicated layout;
    zero halo rows and columns at the domain's edges).

    ``halo`` optionally supplies already-landed ``(top, bot)`` neighbour
    rows (each ``[1, n_l]``) -- the fused solver iteration rides them on
    the grid->tree transposition's all-to-all instead of a permute pair.
    """
    if halo is not None:
        ue = torch.cat([halo[0], u, halo[1]], dim=0)
    elif mg.sharded(l):
        top, bot = _halo_rows_k(u, comm, 1)
        ue = torch.cat([top, u, bot], dim=0)
    else:
        ue = F.pad(u, (0, 0, 1, 1))                   # rows halo
    uc = F.pad(u, (1, 1))                             # cols: Dirichlet
    h = mg.hs[l]
    lap = (a.ke[l] * (ue[2:] - u) + a.kw[l] * (ue[:-2] - u)
           + a.kn[l] * (uc[:, 2:] - u) + a.ks[l] * (uc[:, :-2] - u))
    return mg.gamma * (-lap / (h * h)) + a.dd[l] * u


def _smooth(mg: GridMG, a: MGArrays, l: int, u, b, comm=None):
    for _ in range(mg.nu):
        r = b - _apply_op(mg, a, l, u, comm)
        u = u + mg.omega * r / a.jd[l]
    return u


def _extend(x: torch.Tensor, comm, kh: int, k: int, bf16: bool
            ) -> torch.Tensor:
    """Strip -> ``kh``-row-extended strip with ``k`` real halo rows per
    side (zero-padded to ``kh``).  ``bf16`` rounds the shipped halo rows
    only -- own rows stay exact."""
    if k <= 0:
        z = x.new_zeros((kh,) + tuple(x.shape[1:]))
        return torch.cat([z, x, z], dim=0)
    src = x.to(torch.bfloat16) if bf16 else x
    top, bot = _halo_rows_k(src, comm, k)
    parts = [top.to(x.dtype), x, bot.to(x.dtype)]
    if k < kh:
        z = x.new_zeros((kh - k,) + tuple(x.shape[1:]))
        parts = [z] + parts + [z]
    return torch.cat(parts, dim=0)


def _smooth_deep(mg: GridMG, a: MGArrays, l: int, u_ext, b_ext):
    """``nu`` weighted-Jacobi sweeps on the ``nu``-row-extended strip with
    no per-sweep communication (the fused schedule, DESIGN.md §12).

    Bitwise equal to ``_smooth`` on the own rows: each sweep recomputes
    the ghost rows from the neighbour's exact operands (the extended
    coefficient strips ``a.hc[l]``), so a ghost row holds the same bits
    the neighbour computes for it; validity shrinks one row per sweep and
    the ``b`` halo needs only depth ``nu - 1``.  The caller slices
    ``[nu:-nu]``."""
    hc = a.hc[l]                            # [rows + 2nu, 6, n_l]
    ke, kw, kn, ks, dd, jd = (hc[:, i] for i in range(6))
    h = mg.hs[l]
    u = u_ext
    for _ in range(mg.nu):
        ue = F.pad(u, (0, 0, 1, 1))
        uc = F.pad(u, (1, 1))
        lap = (ke * (ue[2:] - u) + kw * (ue[:-2] - u)
               + kn * (uc[:, 2:] - u) + ks * (uc[:, :-2] - u))
        au = mg.gamma * (-lap / (h * h)) + dd * u
        u = u + mg.omega * (b_ext - au) / jd
    return u


def _restrict(r):
    return 0.25 * (r[0::2, 0::2] + r[1::2, 0::2] + r[0::2, 1::2]
                   + r[1::2, 1::2])


def _prolong(e):
    n0, n1 = e.shape
    return e[:, None, :, None].expand(n0, 2, n1, 2).reshape(2 * n0, 2 * n1)


def _vcycle(mg: GridMG, a: MGArrays, l: int, b, comm=None,
            fused: bool = False, bf16: bool = False):
    # python recursion over static levels: each level's ops get their own
    # named scope ("mg/level0", "mg/level1", ...) in profiles
    #
    # fused (DESIGN.md §12): sharded levels smooth on the nu-row-extended
    # strip -- ONE (nu-1)-row exchange of b before the pre-smooth and ONE
    # nu-row exchange of u before the post-smooth replace the 2*nu
    # per-sweep one-row halos, bitwise (``_smooth_deep``).  The
    # restriction residual keeps its exact one-row exchange.  ``bf16``
    # rounds only the smoothing-halo rows; residual exchanges stay fp32.
    deep = fused and mg.sharded(l) and l < len(a.hc)
    kh = mg.nu
    b_ext = None
    with phase(f"mg/level{l}"):
        if deep:
            b_ext = _extend(b, comm, kh, mg.nu - 1, bf16)
            u = _smooth_deep(mg, a, l, torch.zeros_like(b_ext),
                             b_ext)[kh:-kh]
        else:
            u = _smooth(mg, a, l, torch.zeros_like(b), b, comm)
        if l + 1 < len(mg.levels):
            r = b - _apply_op(mg, a, l, u, comm)
            rc = _restrict(r)
        else:
            return u
    if mg.sharded(l) and not mg.sharded(l + 1):
        # sharded -> replicated switch: gather the coarse strips so the
        # tiny tail levels run redundantly on every rank
        with phase("mg/coarse-gather"):
            rlc = rc.shape[0]
            rc_full = comm.all_gather(rc)
        e = _vcycle(mg, a, l + 1, rc_full, comm, fused, bf16)
        e = e[comm.rank * rlc:(comm.rank + 1) * rlc]
    else:
        e = _vcycle(mg, a, l + 1, rc, comm, fused, bf16)
    with phase(f"mg/level{l}"):
        u = u + _prolong(e)
        if deep:
            u_ext = _extend(u, comm, kh, kh, bf16)
            u = _smooth_deep(mg, a, l, u_ext, b_ext)[kh:-kh]
        else:
            u = _smooth(mg, a, l, u, b, comm)
    return u


def mg_precond_local(mg: GridMG, a: MGArrays, r: torch.Tensor, comm=None,
                     fused: bool = False, bf16: bool = False
                     ) -> torch.Tensor:
    """Apply ``n_cycles`` V-cycles to the flat grid-order residual ``r``.

    One device: ``r`` is the full [n*n] vector.  Sharded (``mg.p > 1``,
    ``a`` from ``mg_local_shard``): ``r`` is the rank's [n*n/p] row strip
    and ``comm`` its group.  The incoming residual is scaled by ``1/h^2``
    -- the preconditioner inverts the UNSCALED local operator
    ``gamma*C + diag(D)`` while the fractional system carries the paper's
    ``h^2`` prefactor.

    ``fused``: deep-halo smoothing on sharded levels (3 exchanges per
    level per cycle instead of ``2*nu + 1``, bitwise-equal results);
    ``bf16`` additionally rounds the smoothing-halo payloads (the
    halo-plan-bf16 comm modes).
    """
    with phase("precond/vcycle"):
        h0 = mg.hs[0]
        strip = mg.p > 1
        rows = (mg.n // mg.p) if strip else mg.n
        b = r.reshape(rows, mg.n) / (h0 * h0)
        gathered = strip and mg.n_sharded == 0
        if gathered:  # too coarse to shard even level 0: replicate fully
            b = comm.all_gather(b)
        u = torch.zeros_like(b)
        for _ in range(mg.n_cycles):
            u = u + _vcycle(mg, a, 0, b - _apply_op(mg, a, 0, u, comm),
                            comm, fused, bf16)
        if gathered:
            u = u[comm.rank * rows:(comm.rank + 1) * rows]
        return u.reshape(r.shape)


def mg_halo_bytes(mg: GridMG, bytes_per_el: int = 4, fused: bool = False,
                  bf16: bool = False) -> int:
    """Per-rank bytes received by ONE preconditioner application.

    Unfused: each stencil application on a sharded level ships two halo
    rows; one V-cycle does ``2*nu + 1`` stencil applications per
    non-coarsest level (two smooths + the restriction residual; the
    cycle-entry residual is counted once at level 0) and ``nu`` on the
    coarsest.  Fused (deep-halo smoothing, DESIGN.md §12): the pre-smooth
    ships one ``(nu-1)``-row b halo, the post-smooth one ``nu``-row u halo
    (both at ``bf16`` width when the comm mode rounds payloads), and only
    the residual exchanges remain one-row fp32.  The sharded->replicated
    switch adds one coarse-grid all_gather either way.
    """
    if mg.p <= 1:
        return 0
    if mg.n_sharded == 0:
        # gathered path: one full-grid all_gather per application (the
        # replicated V-cycle itself is then communication-free)
        return (mg.p - 1) * (mg.n // mg.p) * mg.n * bytes_per_el
    total = 0
    nlev = len(mg.levels)
    bpe_h = 2 if (fused and bf16) else bytes_per_el
    for l in range(min(mg.n_sharded, nlev)):
        n_l = mg.levels[l]
        if fused:
            rows_h = mg.nu - 1                    # pre-smooth b halo
            if l < nlev - 1:
                rows_h += mg.nu                   # post-smooth u halo
            total += 2 * rows_h * n_l * bpe_h
            resid = 1 if l < nlev - 1 else 0      # restriction residual
            if l == 0:
                resid += 1                        # cycle-entry residual
            total += resid * 2 * n_l * bytes_per_el
        else:
            apps = mg.nu if l == nlev - 1 else 2 * mg.nu + 1
            if l == 0:
                apps += 1                         # cycle-entry residual
            total += apps * 2 * n_l * bytes_per_el
    if 0 < mg.n_sharded < nlev:
        n_sw = mg.levels[mg.n_sharded]      # replicated coarse side
        total += (mg.p - 1) * (n_sw * n_sw // mg.p) * bytes_per_el
    return total * mg.n_cycles


def solver_hide_flops(mg: Optional[GridMG], nv: int = 1) -> int:
    """Static per-iteration estimate of the solver compute OUTSIDE the
    H^2 matvec -- the C-stencil application plus the V-cycle smoothing --
    available to hide H^2 halo transfers under.  Feeds the solver-aware
    ``schedule="auto"`` policy (``core.dist._use_split``): when this
    dwarfs a level's coupling-GEMM flops the split schedule's padded
    off-diagonal GEMM buys nothing, so auto keeps the combined form and
    the merged single-round exchange simply lands before phase C.
    """
    if mg is None:
        return 0
    pdiv = mg.p if mg.p > 1 else 1
    # ~11 flops/point per 5-point stencil application, +4 for the Jacobi
    # update riding each smoothing sweep
    total = 11 * (mg.levels[0] ** 2 // pdiv)      # A's stencil term
    vcyc = 0
    nlev = len(mg.levels)
    for l, n_l in enumerate(mg.levels):
        pts = n_l * n_l // (pdiv if mg.sharded(l) else 1)
        apps = mg.nu if l == nlev - 1 else 2 * mg.nu + 1
        if l == 0:
            apps += 1
        vcyc += apps * 15 * pts
    return (total + vcyc * mg.n_cycles) * nv
