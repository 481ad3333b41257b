"""The plain reference of the benchmark: one step of the cell host's
physics, written again in plain PyTorch from the published semantics
(LAMMPS ``pair_style lj/cut``, ``fix edm_pair`` and ``EDMBias`` of
whitead/electronic-dance-music, BAOAB Langevin, JAX's Threefry-2x32 key
chain and the counter hash of the hill draws).  It imports nothing of
``edm_tpu_torch`` and takes nothing that the program derived: it builds
its own cell list, bias interpolation, target grid, boundary tables and
draws from the configuration and from the program's state at the start
of the step.

The program is judged step by step from its own state (MD at kT > 0 is
chaotic, so a reference run from the same start leaves the program's
trajectory within tens of steps).  ``predict`` takes the program's state
before a step and the positions it produced, and returns what the step
should have produced; ``check.py`` compares the two.  Every float is
computed in ``dtype`` (float64 for the reference, a lower precision for
the control); the counter hash and the acceptance threshold are float32,
as the configuration states them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# -------------------------------------------------------------- Threefry


def _rotl(v, r):
    return ((v << np.uint32(r)) | (v >> np.uint32(32 - r))).astype(np.uint32)


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block (20 rounds, Salmon et al. 2011) on uint32
    numpy arrays."""
    with np.errstate(over="ignore"):
        k0, k1 = np.uint32(k0), np.uint32(k1)
        k2 = np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        keys = (k0, k1, k2)
        a = (np.asarray(x0, np.uint32) + k0).astype(np.uint32)
        b = (np.asarray(x1, np.uint32) + k1).astype(np.uint32)
        rots = ((13, 15, 26, 6), (17, 29, 16, 24))
        for i in range(5):
            for r in rots[i % 2]:
                a = (a + b).astype(np.uint32)
                b = _rotl(b, r) ^ a
            a = (a + keys[(i + 1) % 3]).astype(np.uint32)
            b = (b + keys[(i + 2) % 3] + np.uint32(i + 1)).astype(np.uint32)
    return a, b


def split_key(key):
    """JAX's ``split(key)`` (partitionable Threefry): two subkeys, the
    blocks of the counters 0 and 1."""
    a, b = threefry2x32(key[0], key[1], np.zeros(2, np.uint32), np.arange(2, dtype=np.uint32))
    return np.stack([a, b], 1)


def hash_seeds(key):
    """Two uint32 seeds: ``jax.random.bits(key, (2,), uint32)``."""
    a, b = threefry2x32(key[0], key[1], np.zeros(2, np.uint32), np.arange(2, dtype=np.uint32))
    return int(a[0] ^ b[0]), int(a[1] ^ b[1])


# ------------------------------------------------------------ counter hash

M32 = 0xFFFFFFFF


def _mul32(h, m: int):
    """(h * m) mod 2^32 in int64 (h < 2^32): the multiplier in 16-bit halves."""
    return ((h * (m & 0xFFFF)) + (((h * (m >> 16)) & 0xFFFF) << 16)) & M32


def hash_uniform(seeds, rows, cols):
    """The murmur3-finalizer counter hash of (seed0, seed1, row, col),
    broadcast over int64 ``rows`` and ``cols``, as float32 uniforms in
    [0, 1): the hash rounded to float32 times 2^-32."""
    s0, s1 = seeds
    h = (s0 + _mul32(rows & M32, 0x9E3779B9) + _mul32(cols & M32, 0x85EBCA6B)) & M32
    h = h ^ s1
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h.to(torch.float32) * torch.tensor(2.0 ** -32, dtype=torch.float32)


def hash_normals(seeds, rows, n: int, dtype):
    """(R, n) standard normals by Box-Muller from the hash's columns 0..n-1
    (u1, offset by 2^-33 in float32) and n..2n-1 (u2)."""
    cols = torch.arange(2 * n, device=rows.device)
    u = hash_uniform(seeds, rows[:, None], cols[None, :])
    u1 = (u[:, :n] + torch.tensor(2.0 ** -33, dtype=torch.float32)).to(dtype)
    u2 = u[:, n:].to(dtype)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


# ------------------------------------------------------------ the bias


class Bias:
    """The 1-D pair-distance bias of ``fix edm_pair`` on [0, box_high]:
    the grid's geometry (lib/grid.h: n = ceil(L / spacing), one extra
    point and an inflated max on a non-periodic grid), its cubic
    interpolation, the Gaussian hill with the McGovern-De Pablo boundary
    correction (lib/gaussian_grid.h), the nearest-bin target and the
    heights of the well-tempered, targeted hills (lib/edm_bias.cpp)."""

    SUPPORT = 8.0
    BC_SIZE = 65536
    BC_MAR = 2.0

    def __init__(self, b: dict, dtype, device):
        self.cfg, self.dtype, self.device = b, dtype, device
        hi = float(b["box_high"])
        n = int(math.ceil(hi / float(b["bias_spacing"])))
        self.dx = hi / n
        self.G = n + 1
        self.lo, self.max = 0.0, hi + self.dx
        self.bmin, self.bmax = 0.0, hi
        self.sig = float(b["bias_sigma"]) * math.sqrt(2.0)
        self.kT = float(b["boltzmann_constant"]) * float(b["temperature"])
        self.pts = self.lo + self.dx * np.arange(self.G)
        t = b["target"]
        self.target_vals = -2.0 * np.log(np.maximum(self.pts, t["floor"]))
        g = self.target_vals
        w = np.exp(-g - max(g.max(), 0.0))
        self.expected_target = float((g * w).sum() / w.sum())
        self._bc_tables()

    def _bc_tables(self):
        """The boundary-correction denominator and its derivative at each
        grid point (gaussian_grid.h:392-433), float64."""
        s_tab = (np.arange(self.BC_SIZE) * (self.bmax - self.bmin) / (self.BC_SIZE - 1)
                 + self.bmin)
        idx = ((self.BC_SIZE - 1) * (self.pts - self.bmin) / (self.bmax - self.bmin)).astype(
            np.int32).clip(0, self.BC_SIZE - 1)
        s = s_tab[idx]
        sig, lo, hi, m = self.sig, self.bmin, self.bmax, self.BC_MAR
        erf = np.vectorize(math.erf)
        t1 = math.sqrt(math.pi) * sig / 2 * (erf((s - lo) / sig) + erf((hi - s) / sig))
        t2 = math.sqrt(math.pi) * sig / 2 * math.erf((hi - lo) / sig)
        den = t1 + (t2 - t1) * _sigmoid_np((s - lo) / (m * sig)) \
            + (t2 - t1) * _sigmoid_np((hi - s) / (m * sig))
        t3 = np.exp(-((s - lo) ** 2) / sig ** 2) - np.exp(-((hi - s) ** 2) / sig ** 2)
        dden = t3 + (t2 - t1) * _sigmoid_dx_np((s - lo) / (m * sig)) / (m * sig) \
            - t3 * _sigmoid_np((s - lo) / (m * sig))
        dden = dden - (t2 - t1) * _sigmoid_dx_np((hi - s) / (m * sig)) / (m * sig) \
            - t3 * _sigmoid_np((hi - s) / (m * sig))
        self.den = torch.tensor(den, dtype=self.dtype, device=self.device)
        self.dden = torch.tensor(dden, dtype=self.dtype, device=self.device)

    def in_domain(self, r):
        """Where the CV's grid answers: inside the boundary and below the
        last interval (lo <= r < max - dx)."""
        return (r >= self.bmin) & (r <= self.bmax) & (r >= self.lo) & (r < self.max - self.dx)

    def value_deriv(self, values, derivs, r):
        """(V(r), dV/dr), the grid's cubic interpolation from its values and
        derivatives (the reference's DimmedGrid::get_value_deriv), 0 outside
        the domain."""
        dx, G = self.dx, self.G
        idx = torch.clamp(torch.floor((r - self.lo) / dx), 0, G - 1).to(torch.int64)
        t = (r - self.lo - idx.to(r.dtype) * dx) / dx
        val = torch.zeros_like(r)
        der = torch.zeros_like(r)
        for corner, sign in ((0, 1.0), (1, -1.0)):
            node = idx if corner == 0 else torch.clamp(idx + 1, max=G - 1)
            v, d = values[node], derivs[node]
            safe = torch.abs(v) >= 1e-7
            q = torch.where(safe, -d / torch.where(safe, v, torch.ones_like(v)),
                            torch.zeros_like(v))
            X = torch.abs(t - corner)
            X2, X3 = X * X, X * X * X
            C = (1 - 3 * X2 + 2 * X3) - sign * q * (X - 2 * X2 + X3) * dx
            D = ((-6 * X + 6 * X2) - sign * q * (1 - 4 * X + 3 * X2) * dx) * sign / dx
            val = val + v * C
            der = der + v * D
        ok = self.in_domain(r)
        return torch.where(ok, val, torch.zeros_like(val)), torch.where(ok, der,
                                                                         torch.zeros_like(der))

    def target(self, r, bins=None):
        """The nearest-bin target value (0 at and past the last interval);
        ``bins``: the bins to read instead of r's own."""
        tv = torch.tensor(self.target_vals, dtype=self.dtype, device=r.device)
        idx = self.bin_of(r) if bins is None else bins
        ok = (r >= self.lo) & (r < self.max - self.dx)
        return torch.where(ok, tv[idx.clamp(0, self.G - 1)], torch.zeros_like(r))

    def bin_of(self, r):
        return torch.clamp(torch.floor((r - self.lo) / self.dx), 0, self.G - 1).to(torch.int64)

    def other_bin(self, r, band: float):
        """(the neighbouring bin of each r that lies within ``band`` (relative)
        of a bin edge, where float32 may put it; whether it does)."""
        idx = self.bin_of(r)
        lo_edge = self.lo + idx.to(r.dtype) * self.dx
        below = (r - lo_edge) <= band * r
        above = (lo_edge + self.dx - r) <= band * r
        return torch.where(below, idx - 1, idx + 1), below | above

    def heights(self, r, values, derivs, cum_bias, est, bins=None):
        """Per-hill heights (edm_bias.cpp:422-426, 543-558): the prefactor
        after global tempering, the target (read in ``bins``, default each
        r's own), local well-tempering (strictly when global_tempering <
        0), the density, clamped to bias_per_step."""
        b = self.cfg
        gt = float(b.get("global_tempering", 0.0))
        bf = float(b["bias_factor"])
        pref = float(b["hill_prefactor"])
        if b["tempering"] and gt > 0:
            avg = cum_bias / (self.bmax - self.bmin)
            if avg >= gt:
                pref *= math.exp(-(avg - gt) / (gt * (bf - 1) * self.kT))
        h = torch.full_like(r, pref) * torch.exp(self.target(r, bins) - self.expected_target)
        if b["tempering"] and gt < 0:
            h = h * torch.exp(-self.value_deriv(values, derivs, r)[0] / ((bf - 1) * self.kT))
        hd = float(b["hill_density"])
        h = h / (hd if hd >= 0 else est)
        return torch.clamp(h, max=float(b["bias_per_step"]))

    def hill_tables(self, x):
        """(value (G, H), gradient (G, H), integral per unit height (H,)) of
        unit-height hills at ``x``: the Gaussian with the McGovern-De Pablo
        boundary correction on the non-periodic 1-D boundary, zero where the
        grid point or the centre lies outside the boundary or past the
        support."""
        dt, dev = self.dtype, x.device
        xx = torch.tensor(self.pts, dtype=dt, device=dev)[:, None]
        xc = x[None, :]
        sig, lo, hi, m = self.sig, self.bmin, self.bmax, self.BC_MAR
        dp = (xx - xc) / sig
        dp2 = dp * dp
        valid = ((xx >= lo) & (xx <= hi) & (xc >= lo) & (xc <= hi)
                 & (dp2 < self.SUPPORT + 1e-12))
        expo = torch.exp(-dp2)
        t1 = torch.exp(-((xc - lo) ** 2) / sig ** 2)
        t2 = _sigmoid((xx - lo) / (sig * m))
        t3 = torch.exp(-((xc - hi) ** 2) / sig ** 2)
        t4 = _sigmoid((hi - xx) / (sig * m))
        corr = (t1 - expo) * t2 + (t3 - expo) * t4
        den, dden = self.den[:, None], self.dden[:, None]
        t5 = -2 * dp / sig
        t6 = _sigmoid_dx((xx - lo) / (sig * m)) / (m * sig)
        t7 = -_sigmoid_dx((hi - xx) / (sig * m)) / (m * sig)
        f = (t5 * expo + (t1 - expo) * t6 - t5 * expo * t2 + (t3 - expo) * t7
             - t5 * expo * t4)
        f = (f * den - dden * (expo + corr)) / (den * den)
        zero = torch.zeros((), dtype=dt, device=dev)
        val = torch.where(valid, expo / den + corr / den, zero)
        grad = torch.where(valid, f, zero)
        return val, grad, val.sum(0) * self.dx

    def boundary_copies(self, values):
        """Copy the boundary rows outward (duplicate_boundary,
        gaussian_grid.h:571-630) so the bias stays flat past the boundary."""
        lo_i = int(math.floor((self.bmin - self.lo) / self.dx))
        while lo_i * self.dx + self.lo < self.bmin:
            lo_i += 1
        hi_i = int(math.floor((self.bmax - self.lo) / self.dx))
        while hi_i * self.dx + self.lo > self.bmax or hi_i == self.G:
            hi_i -= 1
        values = values.clone()
        if lo_i > 0:
            values[lo_i - 1] = values[lo_i]
        if hi_i < self.G - 1:
            values[hi_i + 1] = values[hi_i]
        return values


def _sigmoid(x):
    core = 2 * x ** 3 - 3 * x ** 2 + 1
    return torch.where(x < 0, torch.ones_like(x), torch.where(x > 1, torch.zeros_like(x), core))


def _sigmoid_dx(x):
    core = 6 * x ** 2 - 6 * x
    return torch.where((x < 0) | (x > 1), torch.zeros_like(x), core)


def _sigmoid_np(x):
    return np.where(x < 0, 1.0, np.where(x > 1, 0.0, 2 * x ** 3 - 3 * x ** 2 + 1))


def _sigmoid_dx_np(x):
    return np.where((x < 0) | (x > 1), 0.0, 6 * x ** 2 - 6 * x)


def hill_round(bias: Bias, values, derivs, cum_bias, buf, r_hills, est, called, band=1e-6):
    """One pre/add/post hill cycle (edm_bias.cpp:413-612) with the hills
    ``r_hills`` in deposit order: the deferred buffer drained first (up to
    256 slots) under bias_per_step, the round skipped while any remains,
    then each called hill deposited in order until the running bias of the
    step reaches bias_per_step, the straddling hill split and the rest
    deferred whole.  Sequential, as the reference's loop is.  ``buf``: the
    deferred (positions, heights) in FIFO order.  Returns (values,
    derivs, cum_bias, deferred count)."""
    cap = float(bias.cfg["bias_per_step"])
    dt = values.dtype
    bpos, bh = buf
    drain_n = min(256, len(bh))
    cum = 0.0
    dep_x, dep_h, left = [], [], []
    if drain_n:
        x = torch.tensor(bpos[:drain_n], dtype=dt, device=values.device)
        s = bias.hill_tables(x)[2].tolist()
        for k in range(drain_n):
            c = bh[k] * s[k]
            if cum > cap:
                left.append((bpos[k], bh[k]))
                continue
            if cum + c > cap:
                undo = max(cap - (cum + c), -bh[k])
                dep_x.append(bpos[k])
                dep_h.append(bh[k] + undo)
                left.append((bpos[k], -undo))
                cum = cum + c + undo * s[k]
            else:
                dep_x.append(bpos[k])
                dep_h.append(bh[k])
                cum += c
    left += list(zip(bpos[drain_n:], bh[drain_n:]))
    skip = bool(left)
    deferred = len(left)
    allow = (torch.zeros_like(values), torch.zeros_like(derivs), 0.0)
    if len(r_hills) and not skip:
        r = r_hills.to(dt)
        h = bias.heights(r, values, derivs, float(cum_bias), est)
        val_t, grad_t, s = bias.hill_tables(r)
        bins, amb = bias.other_bin(r, band)
        dh = torch.where(amb, torch.abs(h - bias.heights(r, values, derivs, float(cum_bias), est,
                                                         bins)), torch.zeros_like(h))
        allow = (torch.abs(val_t) @ dh, torch.abs(grad_t) @ dh, float((dh * s).sum()))
        hl, sl = h.tolist(), s.tolist()
        for k in range(len(hl)):
            if not called[k]:
                continue
            c = hl[k] * sl[k]
            if cum >= cap:
                deferred += 1
            elif cum + c <= cap:
                dep_x.append(float(r[k]))
                dep_h.append(hl[k])
                cum += c
            else:
                undo = max(cap - (cum + c), -hl[k])
                dep_x.append(float(r[k]))
                dep_h.append(hl[k] + undo)
                deferred += int(-undo > 0)
                cum = cum + c + undo * sl[k]
    if dep_x:
        x = torch.tensor(dep_x, dtype=dt, device=values.device)
        hh = torch.tensor(dep_h, dtype=dt, device=values.device)
        val, grad, _ = bias.hill_tables(x)
        values = bias.boundary_copies(values + val @ hh)
        derivs = derivs + grad @ hh
    return values, derivs, float(cum_bias) + cum, deferred, allow


# ------------------------------------------------------------ pairs


HALF = tuple((a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)
             if (a, b, c) > (0, 0, 0))


def neighbor_ids(ncells, offsets, device):
    """(C, len(offsets)) flat ids (x-major) of each cell's neighbours at
    ``offsets``, periodic."""
    nx, ny, nz = ncells
    c = torch.arange(nx * ny * nz, device=device)
    cx, cy, cz = c // (ny * nz), (c // nz) % ny, c % nz
    cols = [((cx + a) % nx) * ny * nz + ((cy + b) % ny) * nz + (cz + d) % nz
            for a, b, d in offsets]
    return torch.stack(cols, 1)


class Pairs:
    """The reference's own cell list over atom positions: cells of edge at
    least ``reach`` (three or more a side), each cell's atoms in a padded
    row.  ``tiles`` visits every unordered pair of atoms in neighbouring
    cells once, in chunks of cells.

    ``listed`` (N, 3), the cell of each atom in the program's slot table
    before the step, restricts the pairs to those that table lists: atoms
    in the same or adjacent cells of its lattice ``listed_ncells``.  The
    table is the configuration's neighbour list, rebuilt every
    ``rebuild_stride`` steps (LAMMPS's ``neigh_modify every 10 check no``):
    a pair whose atoms drifted further apart in the cells than that, yet
    came within reach, is not computed; ``missed`` counts them."""

    def __init__(self, x, box, reach: float, listed=None, listed_ncells=None):
        self.x, self.dev = x, x.device
        self.box = torch.tensor(box, dtype=x.dtype, device=x.device)
        self.reach = reach
        nc = [int(math.floor(b / reach)) for b in box]
        if min(nc) < 3:
            raise ValueError(f"box {box} holds fewer than 3 cells of {reach} a side")
        self.ncells = tuple(nc)
        edge = self.box / torch.tensor(nc, dtype=x.dtype, device=x.device)
        xw = x - self.box * torch.floor(x / self.box)
        c3 = torch.minimum(torch.floor(xw / edge).to(torch.int64),
                           torch.tensor(nc, device=x.device) - 1).clamp(min=0)
        cid = (c3[:, 0] * nc[1] + c3[:, 1]) * nc[2] + c3[:, 2]
        C = nc[0] * nc[1] * nc[2]
        order = torch.argsort(cid, stable=True)
        counts = torch.bincount(cid, minlength=C)
        self.M = int(counts.max())
        start = torch.cumsum(counts, 0) - counts
        rank = torch.arange(len(cid), device=x.device) - start[cid[order]]
        n = x.shape[0]
        self.idx = torch.full((C, self.M), n, dtype=torch.int64, device=x.device)
        self.idx[cid[order], rank] = order
        self.C, self.n = C, n
        self.xp = torch.cat([x, torch.zeros(1, 3, dtype=x.dtype, device=x.device)])
        self.chunk = max(1, int(2e7 // (self.M * self.M)))
        self.listed = None
        if listed is not None:
            self.listed = torch.cat([listed, torch.zeros(1, 3, dtype=listed.dtype,
                                                         device=x.device)]).to(torch.int32)
            self.listed_nc = torch.tensor(listed_ncells, dtype=torch.int32, device=x.device)
        self.missed = 0

    def tiles(self):
        """Yield (I (B, M), J (B, M), d (B, M, M, 3) minimum-image
        displacement x_i - x_j, r2 (B, M, M), ok (B, M, M)): each unordered
        pair of real atoms once (a cell with itself above the diagonal, then
        its 13 half-stencil neighbours), restricted to ``listed``."""
        nbr = neighbor_ids(self.ncells, ((0, 0, 0),) + HALF, self.dev)
        n = self.n
        upper = torch.ones(self.M, self.M, dtype=torch.bool, device=self.dev).triu(1)
        for k in range(nbr.shape[1]):
            for c0 in range(0, self.C, self.chunk):
                I = self.idx[c0:c0 + self.chunk]
                J = self.idx[nbr[c0:c0 + self.chunk, k]]
                d = self.xp[I][:, :, None, :] - self.xp[J][:, None, :, :]
                d = d - torch.round(d / self.box) * self.box
                r2 = (d * d).sum(-1)
                ok = (I < n)[:, :, None] & (J < n)[:, None, :]
                if k == 0:
                    ok = ok & upper
                if self.listed is not None:
                    dc = (self.listed[J][:, None, :, :] - self.listed[I][:, :, None, :]) \
                        % self.listed_nc
                    adj = ((dc <= 1) | (dc == self.listed_nc - 1)).all(-1)
                    self.missed += int((ok & ~adj & (r2 < self.reach * self.reach)).sum())
                    ok = ok & adj
                yield I, J, d, r2, ok


def edge_band(r, edge: float, rel: float):
    """Pairs within float32 rounding of a cut-off at ``edge``: the program
    decides them in float32, the reference in its own precision, so
    either side of the cut is right for them."""
    return torch.abs(r - edge) <= rel * edge


def forces(pairs: Pairs, bias: Bias, values, derivs, lj: dict, band: float, energy: bool):
    """LJ (truncated, unshifted at rcut) plus the pair bias -dV/dr on every
    pair in the bias domain, per atom, each pair's force added to both of
    its atoms; the bias energy; and each atom's allowance: the size of the
    pair forces, and of the energies, of the pairs that lie within ``band``
    of a cut-off (rcut, the grid's last interval); and the scale of the
    forces, the largest sum over an atom of its pair forces' sizes.
    Returns (f (N, 3), e, allow_f (N,), allow_e, scale)."""
    x = pairs.x
    n, dt = pairs.n, x.dtype
    f = torch.zeros(n + 1, 3, dtype=dt, device=x.device)
    allow = torch.zeros(n + 1, dtype=dt, device=x.device)
    size = torch.zeros(n + 1, dtype=dt, device=x.device)
    e = torch.zeros((), dtype=dt, device=x.device)
    allow_e = torch.zeros((), dtype=dt, device=x.device)
    eps, sig, rcut = float(lj["epsilon"]), float(lj["sigma"]), float(lj["rcut"])
    bh = bias.max - bias.dx
    edge = torch.full((1,), bh - bias.dx * 1e-6, dtype=dt, device=x.device)
    v_edge, dv_edge = (float(t) for t in bias.value_deriv(values, derivs, edge))

    def both(acc, I, J, rows, cols):
        acc.index_add_(0, I.reshape(-1), rows.reshape((-1,) + acc.shape[1:]))
        acc.index_add_(0, J.reshape(-1), cols.reshape((-1,) + acc.shape[1:]))

    for I, J, d, r2, ok in pairs.tiles():
        r = torch.sqrt(torch.where(ok, r2, torch.ones_like(r2)))
        inv2 = torch.where(ok, 1.0 / r2.clamp(min=1e-30), torch.zeros_like(r2))
        s6 = (sig * sig * inv2) ** 3
        flj = torch.where(ok & (r < rcut), 4 * eps * (12 * s6 * s6 - 6 * s6) * inv2,
                          torch.zeros_like(r2))
        v, dv = bias.value_deriv(values, derivs, torch.where(ok, r, torch.full_like(r, -1.0)))
        coef = flj - dv / r
        fp = coef[..., None] * d
        both(f, I, J, fp.sum(2), -fp.sum(1))
        sz = torch.abs(coef) * r
        both(size, I, J, sz.sum(2), sz.sum(1))
        near_lj = ok & edge_band(r, rcut, band)
        near_b = ok & edge_band(r, bh, band)
        if bool(near_lj.any()) or bool(near_b.any()):
            a = (torch.where(near_lj, torch.abs(flj * r), torch.zeros_like(r))
                 + torch.where(near_b, torch.full_like(r, abs(dv_edge)), torch.zeros_like(r)))
            both(allow, I, J, a.sum(2), a.sum(1))
            allow_e = allow_e + abs(v_edge) * near_b.sum()
        if energy:
            e = e + torch.where(ok, v, torch.zeros_like(v)).sum()
    return f[:n], e, allow[:n], allow_e, float(size[:n].max())


# ------------------------------------------------------------ slots


def atoms_of(aid, plane, n: int):
    """A slot plane (S, ...) in atom order, and how many atoms the slot
    table holds other than once."""
    aid = aid.reshape(-1)
    occ = aid < n
    out = torch.zeros((n,) + plane.shape[1:], dtype=plane.dtype, device=plane.device)
    out[aid[occ]] = plane[occ]
    seen = torch.bincount(aid[occ], minlength=n)
    return out, int((seen != 1).sum())


def cell_of_f32(x, box, edge, ncells):
    """The program's binning of positions, float32: wrap into the box,
    floor by the cell edge, clip; flat x-major ids."""
    b = torch.tensor(box, dtype=torch.float32, device=x.device)
    e = torch.tensor(edge, dtype=torch.float32, device=x.device)
    x = x.to(torch.float32)
    xw = x - b * torch.floor(x / b)
    nc = torch.tensor(ncells, device=x.device)
    c = torch.minimum(torch.clamp(torch.floor(xw / e).to(torch.int64), min=0), nc - 1)
    return (c[:, 0] * ncells[1] + c[:, 1]) * ncells[2] + c[:, 2]


def rebin(geom: dict, aid, x_slots, kernel_cap=None, overflow_cap=None, tail_count=None):
    """The rebuild's slot table from the table before it and the positions
    in its slots: atoms that left their cell move, in slot order grouped by
    target cell, into the target cell's free slots in slot order (free:
    empty or left this rebuild); when movers exceed the mover budget, a
    target cell lacks room, or (with a kernel cap) the tail past it would
    exceed the overflow cap, every atom is binned anew, in atom order by
    cell.  Returns (the new table, whether the rebuild was incremental)."""
    n, cap, Cg = geom["n_atoms"], geom["cap"], geom["cells_padded"]
    ncells = geom["ncells"]
    edge = [b / c for b, c in zip(geom["box"], ncells)]
    S = Cg * cap
    dev = aid.device
    real = aid < n
    new_c = cell_of_f32(x_slots, geom["box"], edge, ncells)
    cur_c = torch.arange(S, device=dev) // cap
    mover = real & (new_c != cur_c)
    src = torch.nonzero(mover).reshape(-1)
    ok = src.numel() <= geom["mover_cap"]
    dest = None
    if ok:
        tgt = new_c[src]
        order = torch.argsort(tgt, stable=True)
        src, tgt = src[order], tgt[order]
        free = (~real | mover).reshape(Cg, cap)
        # the q-th mover into a cell takes that cell's q-th free slot
        first = torch.ones_like(tgt, dtype=torch.bool)
        first[1:] = tgt[1:] != tgt[:-1]
        pos = torch.arange(len(tgt), device=dev)
        q = pos - torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values
        nfree = free.sum(1)
        ok = bool((q < nfree[tgt]).all()) if len(tgt) else True
        if ok:
            rank = torch.cumsum(free.to(torch.int64), 1) - 1
            slot_of = torch.full((Cg, cap + 1), -1, dtype=torch.int64, device=dev)
            cells = torch.arange(Cg, device=dev)[:, None].expand(Cg, cap)
            slot_of[cells[free], rank[free]] = torch.arange(cap, device=dev).expand(Cg, cap)[free]
            dest = tgt * cap + slot_of[tgt, q]
            if kernel_cap is not None:
                leave = int(((src % cap) >= kernel_cap).sum())
                arrive = int(((dest % cap) >= kernel_cap).sum())
                ok = int(tail_count) - leave + arrive <= overflow_cap
    if ok:
        new = aid.clone()
        new[src] = n
        new[dest] = aid[src]
        return new, True
    x_at, _ = atoms_of(aid, x_slots, n)
    cid = cell_of_f32(x_at, geom["box"], edge, ncells)
    order = torch.argsort(cid, stable=True)
    cs = cid[order]
    first = torch.ones_like(cs, dtype=torch.bool)
    first[1:] = cs[1:] != cs[:-1]
    pos = torch.arange(n, device=dev)
    rank = pos - torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values
    new = torch.full((S,), n, dtype=torch.int64, device=dev)
    keep = rank < cap
    new[(cs * cap + rank)[keep]] = order[keep]
    return new, False


# ------------------------------------------------------------ one step


def baoab(x, v, f, f_new, xi, lg: dict):
    """BAOAB: half kick, half drift, the Ornstein-Uhlenbeck update with
    noise ``xi``, half drift; then the half kick with the new forces."""
    dt, m, gam, kT = (float(lg[k]) for k in ("dt", "mass", "friction", "kT"))
    c1 = math.exp(-gam * dt)
    c2 = math.sqrt(max(0.0, 1.0 - c1 * c1) * kT / m)
    v1 = v + (0.5 * dt / m) * f
    x1 = x + (0.5 * dt) * v1
    v2 = c1 * v1 + c2 * xi
    x2 = x1 + (0.5 * dt) * v2
    return x2, v2 + (0.5 * dt / m) * f_new


def collect(pairs: Pairs, slot_of_atom, geom: dict, seeds, thresh, bmax: float, host: dict):
    """The hill round's candidates (fix_edm_pair.cpp:229-237): every
    unordered pair within the CV's box_high that the slot table lists
    (``Pairs``), as the row of the program's
    half-stencil layout that lists it (the lower slot of a shared cell, or
    the atom whose cell has the other's at a positive half offset), with
    two acceptance draws at its columns 2w and 2w + 1 of that row.
    Returns (accepted hills in the program's deposit order, as (row, col, r)
    sorted, the candidate draws counted, truncated: more than
    hill_capacity hills, row_cap rows or m_per_row in a row)."""
    cap = geom["cap"]
    ncells = geom["ncells"]
    dev = pairs.dev
    half = neighbor_ids(ncells, HALF, dev)  # (C, 13) of the program's lattice
    rows_l, cols_l, r_l = [], [], []
    n_cand = 0
    for I, J, d, r2, ok in pairs.tiles():
        cand = ok & (r2 < bmax * bmax)
        if not bool(cand.any()):
            continue
        ii = I[:, :, None].expand_as(cand)[cand]
        jj = J[:, None, :].expand_as(cand)[cand]
        rr = torch.sqrt(r2[cand])
        n_cand += ii.numel()
        si, sj = slot_of_atom[ii], slot_of_atom[jj]
        ci, cj = si // cap, sj // cap
        same = ci == cj
        ki = (half[ci] == cj[:, None])  # j's cell at a positive offset of i's
        kj = (half[cj] == ci[:, None])
        i_row = same & (si < sj) | (~same & ki.any(1))
        row = torch.where(same, torch.minimum(si, sj), torch.where(i_row, si, sj))
        other = torch.where(same, torch.maximum(si, sj), torch.where(i_row, sj, si))
        k = torch.where(i_row, ki.to(torch.int64).argmax(1), kj.to(torch.int64).argmax(1))
        w = torch.where(same, other % cap, (1 + k) * cap + other % cap)
        for b in (0, 1):
            col = 2 * w + b
            u = hash_uniform(seeds, row, col)
            acc = u < thresh
            rows_l.append(row[acc])
            cols_l.append(col[acc])
            r_l.append(rr[acc])
    rows = torch.cat(rows_l) if rows_l else torch.zeros(0, dtype=torch.int64, device=dev)
    cols = torch.cat(cols_l) if cols_l else torch.zeros(0, dtype=torch.int64, device=dev)
    rs = torch.cat(r_l) if r_l else torch.zeros(0, dtype=pairs.x.dtype, device=dev)
    order = torch.argsort(rows * (4 * 14 * cap) + cols)
    rows, cols, rs = rows[order], cols[order], rs[order]
    # each row's first m_per_row, the first row_cap rows, the first
    # hill_capacity hills
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    pos = torch.arange(len(rows), device=dev)
    place = pos - torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values
    row_rank = torch.cumsum(first.to(torch.int64), 0) - 1
    keep = (place < host["m_per_row"]) & (row_rank < host["row_cap"])
    truncated = bool((place >= host["m_per_row"]).any()) or (
        int(first.sum()) > host["row_cap"]) or int(keep.sum()) > host["hill_capacity"]
    rs = rs[keep][:host["hill_capacity"]]
    return rs, 2 * n_cand, truncated


def predict(cfg: dict, geom: dict, s0: dict, s1: dict, phase: str, dtype=torch.float64,
            band: float = 1e-6) -> dict:
    """What the program's step of ``phase`` should produce from its state
    ``s0`` (a plain snapshot), given the positions ``s1`` shows it moved the
    atoms to.  Each stage is judged from the program's own inputs: the
    positions and velocities from s0's positions, velocities, forces and
    the thermostat draws; the forces and the bias energy from s1's
    positions and s0's grid; the hill round from s1's positions, s0's
    grid, key and candidate count; the slot table from s0's table and s1's
    positions.  Returns atom-order arrays and the scalars to compare."""
    n = geom["n_atoms"]
    cap = geom["cap"]
    S = geom["cells_padded"] * cap
    dev = s0["xs"].device
    bcfg, lg, host = cfg["bias"], cfg["langevin"], cfg["host"]
    out = {}
    # the key chain: one split a step for the thermostat, one more a round
    key, sub_noise = split_key(s0["key"])
    seeds_noise = hash_seeds(sub_noise)
    if phase == "hill":
        key, sub_hill = split_key(key)
    out["key"] = key
    out["step"] = int(s0["step"]) + 1
    # the integrator, per atom of the program's table before the step
    aid0 = s0["aid"]
    x0, miss0 = atoms_of(aid0, s0["xs"].reshape(S, 3).to(dtype), n)
    v0, _ = atoms_of(aid0, s0["vs"].reshape(S, 3).to(dtype), n)
    f0, _ = atoms_of(aid0, s0["fs"].reshape(S, 3).to(dtype), n)
    occ = aid0 < n
    slot_of_atom = torch.full((n,), S, dtype=torch.int64, device=dev)
    slot_of_atom[aid0[occ]] = torch.nonzero(occ).reshape(-1)
    xi = hash_normals(seeds_noise, slot_of_atom, 3, dtype)
    x1p, miss1 = atoms_of(s1["aid"], s1["xs"].reshape(S, 3).to(dtype), n)
    f1p, _ = atoms_of(s1["aid"], s1["fs"].reshape(S, 3).to(dtype), n)
    out["x"], out["v"] = baoab(x0, v0, f0, f1p, xi, lg)
    out["x_start"] = x0
    out["table_misses"] = miss0 + miss1
    # the force pass at the positions the program reached, on s0's grid
    values = s0["grid_values"].to(dtype)
    derivs = s0["grid_derivs"].to(dtype)
    bias = Bias(bcfg, dtype, dev)
    reach = max(float(cfg["lj"]["rcut"]), float(bcfg["box_high"]))
    nx, ny, nz = geom["ncells"]
    cell = slot_of_atom // cap
    listed = torch.stack([cell // (ny * nz), (cell // nz) % ny, cell % nz], 1)
    pairs = Pairs(x1p, geom["box"], reach, listed, geom["ncells"])
    energy = phase == "hill"
    f, e, allow, allow_e, scale = forces(pairs, bias, values, derivs, cfg["lj"], band, energy)
    out["f"], out["f_allow"], out["f_scale"] = f, allow, scale
    out["missed_pairs"] = pairs.missed
    if energy:
        out["energy"], out["energy_allow"] = float(e), float(allow_e)
    if phase == "hill":
        thresh = (torch.tensor(float(bcfg["hill_density"]), dtype=torch.float32)
                  / torch.tensor(float(s0["last_calls"]), dtype=torch.float32))
        rs, calls, truncated = collect(pairs, slot_of_atom, geom, hash_seeds(sub_hill),
                                       float(thresh), float(bcfg["box_high"]), host)
        nb = int(s0["buf_right"]) - int(s0["buf_left"])
        lo = int(s0["buf_left"])
        buf = (s0["buf_pos"][lo:lo + nb].tolist(), s0["buf_h"][lo:lo + nb].tolist())
        called = [True] * len(rs)
        nv, nd, cum, deferred, allow = hill_round(bias, values, derivs, float(s0["cum_bias"]),
                                                  buf, rs, float(s0["last_calls"]), called, band)
        out.update(grid_values=nv, grid_derivs=nd, cum_bias=cum, deferred=deferred,
                   last_calls=calls, truncated=truncated, hills=len(rs), grid_allow=allow)
    if phase == "rebuild":
        # the program's float32 positions, in the slots of the table before
        # the step: the rebuild bins what the step reached
        x32, _ = atoms_of(s1["aid"], s1["xs"].reshape(S, 3), n)
        xs_slots = torch.zeros(S, 3, dtype=x32.dtype, device=dev)
        xs_slots[occ] = x32[aid0[occ]]
        kcap = s0.get("kernel_cap")
        new, incremental = rebin(geom, aid0, xs_slots, kcap, s0.get("overflow_cap"),
                                 s0.get("tail_count"))
        out["aid"], out["incremental"] = new, incremental
        if kcap is not None:
            tail = int(((new < n).reshape(-1, cap)[:, kcap:]).sum())
            out["tail_count"] = tail
            out["tail_fallbacks"] = int(s0["tail_fallbacks"]) + int(
                (not incremental) and tail > s0["overflow_cap"])
    return out
