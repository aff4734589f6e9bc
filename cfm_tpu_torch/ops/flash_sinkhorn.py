"""Flash Sinkhorn: entropic OT potentials that never materialise the (n, m)
cost (counterpart of ``cfm_tpu/ops/flash_sinkhorn.py``; TPU kernel #7).

For the squared-Euclidean cost between point clouds x (n, d) and y (m, d),
the log-domain Sinkhorn updates need only the cost's tiles,
c_ij = |x_i|^2 + |y_j|^2 - 2 x_i.y_j, reduced by an online (running max and
sum) logsumexp. Each iteration sets f from g, then g from the new f, then
measures the implied plan's row-marginal L1 error, and the loop stops at
err <= tol or after ``num_iters``.

- :func:`flash_sinkhorn_reference` is the plain PyTorch version of the TPU
  kernel ``_flash_kernel``: the same (tile_i, tile_j) tiles, the online LSE
  from ``_NEG``, the error every iteration (:func:`flash_row_error`). It is
  the CPU path and the oracle the CUDA kernel is held against; it reads the
  error back to the host every iteration.
- :func:`flash_sinkhorn` is the wrapper. A CPU tensor runs the plain
  version; a CUDA tensor launches the Hopper kernel ``csrc/flash_sinkhorn.cu``
  (one persistent cooperative launch whose iteration loop never leaves the
  card; two passes an iteration, the error fused into the next f pass) or
  raises. It never falls back.
- :func:`sinkhorn_from_points` centres the clouds and routes: a CUDA tensor
  that passes :func:`flash_kernel_supported` goes to the kernel; anything
  else to :func:`_flash_sinkhorn_dense`, the dense cost plus
  ``ops/sinkhorn.sinkhorn_potentials`` (error checked every 10th
  iteration), which is what the JAX package runs off the TPU.
- The consumers never form the plan either; they run over row chunks in
  plain PyTorch, as in JAX: :func:`plan_sample_from_potentials` (one j per
  row by Gumbel-max), :func:`row_marginal_error_from_potentials` and
  :func:`transport_cost_from_potentials`.

The kernel itself takes any n, m >= 1 and d >= 1 with n*d and m*d below
2^31 (it tiles the other cloud through shared memory where it does not
fit). Routing keeps the TPU kernel's conditions, so a given (n, m, d) takes
the same route on the card as on the TPU: tile-aligned sizes
(:func:`_pallas_tiles`) and a point budget of 4*d*(n+m) <= 8 MiB.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from cfm_tpu_torch.ops import _build
from cfm_tpu_torch.ops.sinkhorn import _f32, sinkhorn_potentials

_NEG = -3.0e38
_POINT_BUDGET_BYTES = 8 * 1024 * 1024


def _pick_tile(size: int, target: int) -> int:
    """The largest divisor of ``size`` that is <= ``target``."""
    t = min(size, target)
    while size % t:
        t -= 1
    return max(t, 1)


def _pick_aligned_tile(size: int, target: int, align: int) -> Optional[int]:
    """The largest divisor of ``size`` that is <= target and a multiple of
    ``align``; ``size`` itself when it is <= target; None if nothing fits."""
    if size <= target:
        return size
    t = (target // align) * align
    while t >= align:
        if size % t == 0:
            return t
        t -= align
    return None


def _pallas_tiles(n: int, m: int) -> Optional[Tuple[int, int]]:
    """The TPU kernel's (tile_i, tile_j): multiples of 8 and 128, at most 512."""
    tile_i = _pick_aligned_tile(n, 512, 8)
    tile_j = _pick_aligned_tile(m, 512, 128)
    if tile_i is None or tile_j is None:
        return None
    return tile_i, tile_j


def flash_kernel_supported(n: int, m: int, d: int, device) -> bool:
    """True when the kernel route is taken: a CUDA tensor (the TPU backend's
    place in JAX's rule), tile-aligned sizes and the clouds within the point
    budget."""
    if torch.device(device).type != "cuda":
        return False
    if _pallas_tiles(n, m) is None:
        return False
    return 4 * d * (n + m) <= _POINT_BUDGET_BYTES


def _center(x2: torch.Tensor, y2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Remove the joint mean: the cost is translation-invariant, and its dot
    form loses f32 precision when the clouds sit far from the origin."""
    mu = 0.5 * (x2.mean(dim=0) + y2.mean(dim=0))
    return (x2 - mu).float(), (y2 - mu).float()


def _cost_chunk(xc: torch.Tensor, y: torch.Tensor, sqy: torch.Tensor) -> torch.Tensor:
    return xc.square().sum(dim=1)[:, None] + sqy[None, :] - 2.0 * (xc @ y.T)


class _Tiled:
    """The TPU kernel's view of two centred f32 clouds: the (tile_i, tile_j)
    tiles (the kernel's own, else 512 x 512 with ragged tails), the squared
    norms, and the online-LSE reductions over cost tiles built on the fly."""

    def __init__(self, x, y, reg):
        self.n, self.m = x.shape[0], y.shape[0]
        self.ti, self.tj = _pallas_tiles(self.n, self.m) or (min(self.n, 512), min(self.m, 512))
        self.x, self.y = x.float(), y.float()
        self.reg = _f32(reg, x.device)
        self.sqx, self.sqy = self.x.square().sum(dim=1), self.y.square().sum(dim=1)

    def cost(self, i0, j0):
        ti, tj = self.ti, self.tj
        return (self.sqx[i0:i0 + ti, None] + self.sqy[None, j0:j0 + tj]
                - 2.0 * (self.x[i0:i0 + ti] @ self.y[j0:j0 + tj].T))

    def _online(self, blocks, dim, size):
        """Running max from _NEG (not -inf, whose difference is NaN) and sum."""
        run_m = torch.full((size,), _NEG, device=self.x.device)
        run_s = torch.zeros(size, device=self.x.device)
        for z in blocks:
            nm = torch.maximum(run_m, z.amax(dim=dim))
            e = torch.exp(z - (nm[:, None] if dim == 1 else nm[None, :]))
            run_s = run_s * torch.exp(run_m - nm) + e.sum(dim=dim)
            run_m = nm
        return run_m + torch.log(run_s)

    def row_lse(self, g, i0):
        """LSE_j((g_j - c_ij) / reg) for the row block at i0."""
        return self._online(((g[None, j0:j0 + self.tj] - self.cost(i0, j0)) / self.reg
                             for j0 in range(0, self.m, self.tj)), 1, min(self.ti, self.n - i0))

    def col_lse(self, f, j0):
        """LSE_i((f_i - c_ij) / reg) for the column block at j0."""
        return self._online(((f[i0:i0 + self.ti, None] - self.cost(i0, j0)) / self.reg
                             for i0 in range(0, self.n, self.ti)), 0, min(self.tj, self.m - j0))

    def row_error(self, f, g, loga) -> torch.Tensor:
        """The stopping statistic: sum_i |exp(row_lse_i + f_i / reg) - a_i|."""
        err = torch.zeros((), device=self.x.device)
        for i0 in range(0, self.n, self.ti):
            lse = self.row_lse(g, i0) + f[i0:i0 + self.ti] / self.reg
            err = err + torch.sum(torch.abs(torch.exp(lse) - torch.exp(loga[i0:i0 + self.ti])))
        return err


def flash_sinkhorn_reference(x: torch.Tensor, y: torch.Tensor, loga: torch.Tensor,
                             logb: torch.Tensor, reg, num_iters: int, tol: float
                             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Plain version of the kernel on centred f32 clouds: (f (n,), g (m,),
    iterations).

    A transcription of ``_flash_kernel``: potentials from 0; each iteration
    f from the old g (row blocks), g from the new f (column blocks), then the
    row-marginal L1 error of the implied plan (:func:`flash_row_error`); stop
    at err <= tol or after ``num_iters``. Each block's LSE runs over the
    other axis's tiles (the TPU kernel's, else 512 x 512 with ragged tails)
    with a running max from ``_NEG`` and a running sum. The error is read on
    the host every iteration.
    """
    t = _Tiled(x, y, reg)
    loga, logb = loga.float(), logb.float()
    f, g = torch.zeros(t.n, device=x.device), torch.zeros(t.m, device=x.device)
    err, it = float("inf"), 0
    while err > tol and it < num_iters:
        f = torch.cat([t.reg * (loga[i0:i0 + t.ti] - t.row_lse(g, i0))
                       for i0 in range(0, t.n, t.ti)])
        g = torch.cat([t.reg * (logb[j0:j0 + t.tj] - t.col_lse(f, j0))
                       for j0 in range(0, t.m, t.tj)])
        err = float(t.row_error(f, g, loga))
        it += 1
    return f, g, it


def flash_row_error(x: torch.Tensor, y: torch.Tensor, f: torch.Tensor, g: torch.Tensor,
                    loga: torch.Tensor, reg) -> torch.Tensor:
    """The plain version's stopping statistic for potentials (f, g) of the
    centred clouds: the row-marginal L1 error of the implied plan, in f32 as
    the loop measures it (a 0-d tensor)."""
    return _Tiled(x, y, reg).row_error(f.float(), g.float(), loga.float())


def _flash_sinkhorn_dense(x, y, loga, logb, reg, num_iters, tol):
    """The materialised-cost twin (the JAX package's ``_flash_sinkhorn_xla``):
    the dense cost of the centred clouds and ``sinkhorn_potentials``."""
    M = (x.square().sum(dim=1)[:, None] + y.square().sum(dim=1)[None, :]
         - 2.0 * x.float() @ y.float().T)
    return sinkhorn_potentials(loga, logb, M, reg, num_iters=num_iters, tol=tol)


def flash_sinkhorn(x: torch.Tensor, y: torch.Tensor, loga: torch.Tensor, logb: torch.Tensor,
                   reg, num_iters: int = 1000, tol: float = 1e-6
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Potentials (f (n,), g (m,)) of centred f32 clouds x (n, d), y (m, d)
    with log-marginals ``loga``, ``logb``.

    On a CUDA tensor this launches the Hopper kernel, adds one to
    ``flash_sinkhorn.launches`` and leaves the iteration count on the device
    in ``flash_sinkhorn.last_iters``; ``reg`` and ``tol`` reach the kernel as
    device scalars and nothing is read back. On a CPU tensor it runs
    :func:`flash_sinkhorn_reference`.
    """
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"x (n, d) and y (m, d) expected, got {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    if n == 0 or m == 0 or d == 0 or loga.shape != (n,) or logb.shape != (m,):
        raise ValueError(f"empty clouds or marginals of the wrong shape: n={n}, m={m}, d={d}, "
                         f"loga {tuple(loga.shape)}, logb {tuple(logb.shape)}")
    if x.device.type == "cpu":
        f, g, it = flash_sinkhorn_reference(x, y, loga, logb, reg, num_iters, tol)
        flash_sinkhorn.last_iters = torch.tensor(it)
        return f, g
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if max(n, m) * d >= 2 ** 31:
        raise ValueError("the kernel indexes with int32: n*d and m*d must be < 2^31")
    dev = x.device
    x, y = x.float().contiguous(), y.float().contiguous()
    loga, logb = loga.float().contiguous(), logb.float().contiguous()
    # The squared norms at d != 2, rounded as the plain version rounds them;
    # at d = 2 the kernel computes the same bits itself.
    sqx, sqy = (None, None) if d == 2 else (x.square().sum(dim=1), y.square().sum(dim=1))
    scal = torch.stack([_f32(reg, dev), _f32(tol, dev)])
    f, g = torch.empty(n, device=dev), torch.empty(m, device=dev)
    scratch = torch.empty(-(-n // 4) * 4 + 2048, device=dev)  # the second f, the error partials
    iters = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.flash_sinkhorn_solve(
            x.data_ptr(), y.data_ptr(), loga.data_ptr(), logb.data_ptr(),
            None if sqx is None else sqx.data_ptr(), None if sqy is None else sqy.data_ptr(),
            scal.data_ptr(),
            f.data_ptr(), g.data_ptr(), scratch.data_ptr(), iters.data_ptr(), n, m, d, num_iters,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash sinkhorn launch failed: CUDA error {err}")
    flash_sinkhorn.launches += 1
    flash_sinkhorn.last_iters = iters
    return f, g


flash_sinkhorn.launches = 0
flash_sinkhorn.last_iters = None


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_sinkhorn")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_sinkhorn_solve.argtypes = [p] * 11 + [i] * 4 + [p]
        lib.flash_sinkhorn_solve.restype = i
        lib._typed = True
    return lib


def _log_uniform(k: int, w: Optional[torch.Tensor], device) -> torch.Tensor:
    w = torch.full((k,), 1.0 / k, device=device) if w is None else w.to(device)
    return torch.log(w.float())


def sinkhorn_from_points(x: torch.Tensor, y: torch.Tensor, reg, a: Optional[torch.Tensor] = None,
                         b: Optional[torch.Tensor] = None, num_iters: int = 1000,
                         tol: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entropic-OT potentials (f, g) for the squared-Euclidean cost, from the
    point clouds (flattened to (n, d) and centred). The plan is
    pi_ij = exp((f_i + g_j - c_ij) / reg); use the chunked consumers below
    instead of forming it."""
    n, m = x.shape[0], y.shape[0]
    loga, logb = _log_uniform(n, a, x.device), _log_uniform(m, b, x.device)
    x2, y2 = _center(x.reshape(n, -1), y.reshape(m, -1))
    if flash_kernel_supported(n, m, x2.shape[1], x2.device):
        return flash_sinkhorn(x2, y2, loga, logb, reg, num_iters, tol)
    return _flash_sinkhorn_dense(x2, y2, loga, logb, reg, num_iters, tol)


def _chunks(x, y, chunk):
    n = x.shape[0]
    x2, y2 = _center(x.reshape(n, -1), y.reshape(y.shape[0], -1))
    return x2, y2, y2.square().sum(dim=1), _pick_tile(n, chunk)


def plan_sample_from_potentials(generator: Optional[torch.Generator], x: torch.Tensor,
                                y: torch.Tensor, f: torch.Tensor, g: torch.Tensor, reg,
                                chunk: int = 1024, gumbel: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """For every row i, j ~ pi(. | i) by Gumbel-max over the logits
    (g_j - c_ij) / reg, row chunk by row chunk: (n,) int64 column indices.
    ``gumbel`` (n, m) is the Gumbel noise, drawn from ``generator`` chunk by
    chunk when not given. f is not needed: a row-constant shift."""
    del f
    x2, y2, sqy, chunk = _chunks(x, y, chunk)
    n, m = x2.shape[0], y2.shape[0]
    out = []
    for i0 in range(0, n, chunk):
        logits = (g[None, :] - _cost_chunk(x2[i0:i0 + chunk], y2, sqy)) / reg
        if gumbel is None:
            gum = -torch.empty(logits.shape, device=logits.device).exponential_(
                generator=generator).log()
        else:
            gum = gumbel[i0:i0 + chunk]
        out.append(torch.argmax(logits + gum, dim=1))
    return torch.cat(out)


def row_marginal_error_from_potentials(x: torch.Tensor, y: torch.Tensor, f: torch.Tensor,
                                       g: torch.Tensor, reg, a: Optional[torch.Tensor] = None,
                                       chunk: int = 1024) -> torch.Tensor:
    """Largest relative row-marginal error of the implied plan, a 0-d
    tensor: a convergence certificate for a finished solve, one chunked
    pass."""
    x2, y2, sqy, chunk = _chunks(x, y, chunk)
    n = x2.shape[0]
    a = torch.full((n,), 1.0 / n, device=x2.device) if a is None else a.float()
    parts = []
    for i0 in range(0, n, chunk):
        c = _cost_chunk(x2[i0:i0 + chunk], y2, sqy)
        row = torch.exp((f[i0:i0 + chunk, None] + g[None, :] - c) / reg).sum(dim=1)
        ac = a[i0:i0 + chunk]
        parts.append(torch.max(torch.abs(row - ac) / torch.clamp(ac, min=1e-30)))
    return torch.stack(parts).max()


def transport_cost_from_potentials(x: torch.Tensor, y: torch.Tensor, f: torch.Tensor,
                                   g: torch.Tensor, reg, chunk: int = 1024) -> torch.Tensor:
    """<pi, C> accumulated over row chunks (the ``pot.sinkhorn2`` value), a
    0-d tensor; the marginals are in the potentials."""
    x2, y2, sqy, chunk = _chunks(x, y, chunk)
    parts = []
    for i0 in range(0, x2.shape[0], chunk):
        c = _cost_chunk(x2[i0:i0 + chunk], y2, sqy)
        parts.append(torch.sum(torch.exp((f[i0:i0 + chunk, None] + g[None, :] - c) / reg) * c))
    return torch.stack(parts).sum()
