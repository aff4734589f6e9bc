"""Neural-graphical-model ODE functions for gene-regulatory-network and
causal-structure learning (counterpart of ``cfm_tpu/models/grn.py``).

Per-gene MLP vector fields x (n, d) -> v (n, d) whose first-layer weight
norms encode an adjacency (the learned graph), with group-lasso
regularisers for structure recovery; hypernetwork, Bayesian-gate and DiBS
variants; ensembles as a stacked parameter axis (``torch.func`` over one
module); and the SVGD transport direction of a particle posterior.

Layouts follow flax, so :func:`models.convert.mlpodef_params_from_flax` maps
each leaf by its name: ``fc1`` is an ``nn.Linear`` whose weight is flax's
(d_in, d * k) kernel transposed, and ``get_structure`` transposes it back
before grouping; ``LocallyConnected`` keeps flax's (d, m_in, m_out) weight.
Initialisation follows flax's: lecun-normal kernels (fan-in the input axis
times any leading axes, as flax's variance scaling counts them), zero
biases, drawn from a CPU generator seeded with ``seed``.

The JAX ``svgd_update`` flattens the particle pytree as a whole and then
reshapes it to (P, -1), which mixes particles when there is more than one
leaf; :func:`svgd_update` builds each particle's vector from its own slice
of every leaf. The two agree on a single leaf.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cfm_tpu_torch.device import DeviceLike
from cfm_tpu_torch.models.mlp import lecun_normal_

Params = Mapping[str, torch.Tensor]


def _lecun(shape: Sequence[int], fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's lecun-normal draw of ``shape`` with the given fan-in."""
    numel = math.prod(shape)
    w = torch.empty(numel // fan_in, fan_in)
    lecun_normal_(w, generator)
    return w.reshape(tuple(shape))


class _Seeded(nn.Module):
    """A module whose parameters are drawn by ``reset_parameters(generator)``."""

    def _init(self, seed: int, device: DeviceLike) -> None:
        self.reset_parameters(torch.Generator().manual_seed(seed))
        if device is not None:
            self.to(device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        raise NotImplementedError


@torch.no_grad()
def _dense_init(layer: nn.Linear, generator: torch.Generator) -> None:
    lecun_normal_(layer.weight, generator)
    layer.bias.zero_()


class LocallyConnected(_Seeded):
    """A separate linear map per variable: (n, d, m_in) -> (n, d, m_out),
    weight (d, m_in, m_out), bias (d, m_out)."""

    def __init__(self, num_vars: int, m_in: int, m_out: int, use_bias: bool = True,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_vars, m_in, m_out))
        self.bias = nn.Parameter(torch.empty(num_vars, m_out)) if use_bias else None
        self._init(seed, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        d, m_in, _ = self.weight.shape
        self.weight.copy_(_lecun(self.weight.shape, d * m_in, generator))
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.einsum("ndm,dmo->ndo", x, self.weight)
        return out + self.bias if self.bias is not None else out


def _hidden_layers(module: nn.Module, dims: Sequence[int], m_in: int, num_vars: int) -> None:
    """The locally-connected layers fc2_0 ... of dims[2:], the first taking
    ``m_in`` features a variable."""
    for i in range(len(dims) - 2):
        setattr(module, f"fc2_{i}", LocallyConnected(num_vars, m_in, dims[i + 2]))
        m_in = dims[i + 2]


def _run_hidden(module: nn.Module, h: torch.Tensor, n_layers: int) -> torch.Tensor:
    for i in range(n_layers):
        h = getattr(module, f"fc2_{i}")(F.elu(h))
    return h[..., 0]


def _param(module: nn.Module, params: Optional[Params], name: str) -> torch.Tensor:
    return module.get_parameter(name) if params is None else params[name]


class MLPODEF(_Seeded):
    """Per-gene MLP ODE function. dims = [d, k, ..., 1]: d variables, k
    first-layer hidden units a gene, one output a gene. ``fc1`` mixes every
    gene into each gene's hidden units; its weights grouped by (input gene,
    output gene) are the learned adjacency.

    The structure and regularisers read this module's parameters, or
    ``params`` (names as in ``named_parameters()``, with any leading axes,
    such as an ensemble's member axis)."""

    def __init__(self, dims: Sequence[int], time_invariant: bool = True, gl_reg: float = 0.01,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        if dims[-1] != 1:
            raise ValueError(f"the last of dims must be 1 (one output a gene), got {dims}")
        self.dims, self.time_invariant, self.gl_reg = list(dims), time_invariant, gl_reg
        d, k = dims[0], dims[1]
        self.fc1 = nn.Linear(d, d * k)
        _hidden_layers(self, dims, k + (0 if time_invariant else 1), d)
        self._init(seed, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        _dense_init(self.fc1, generator)
        for i in range(len(self.dims) - 2):
            getattr(self, f"fc2_{i}").reset_parameters(generator)

    def forward(self, t, x: torch.Tensor) -> torch.Tensor:
        d, k = self.dims[0], self.dims[1]
        h = self.fc1(x).reshape(-1, d, k)
        if not self.time_invariant:
            tb = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1, 1, 1)
            h = torch.cat([h, tb.expand(h.shape[0], d, 1)], dim=-1)
        return _run_hidden(self, h, len(self.dims) - 2)

    def _fc1_groups(self, params: Optional[Params]) -> torch.Tensor:
        """fc1's flax kernel (..., d_in, d * k) as (..., i, j, k) groups."""
        d, k = self.dims[0], self.dims[1]
        w = _param(self, params, "fc1.weight").transpose(-1, -2)
        return w.reshape(w.shape[:-2] + (d, d, k))

    def get_structure(self, params: Optional[Params] = None) -> torch.Tensor:
        """(d, d) edge scores: the L2 norm of each (input gene i, output gene
        j) group of fc1; entry [i, j] scores the edge i -> j."""
        return torch.sqrt(torch.sum(torch.square(self._fc1_groups(params)), dim=-1))

    def l1_reg(self, params: Optional[Params] = None) -> torch.Tensor:
        return torch.sum(torch.abs(_param(self, params, "fc1.weight")))

    def l2_reg(self, params: Optional[Params] = None) -> torch.Tensor:
        reg = torch.sum(torch.square(_param(self, params, "fc1.weight")))
        for i in range(len(self.dims) - 2):
            reg = reg + torch.sum(torch.square(_param(self, params, f"fc2_{i}.weight")))
        return reg

    def group_lasso_reg(self, params: Optional[Params] = None, gamma: float = 0.5
                        ) -> torch.Tensor:
        """The adaptive group-lasso penalty on fc1's groups: gl_reg times the
        sum of scores / (scores^2 + 1e-12)^gamma, the weights held constant."""
        scores = self.get_structure(params)
        weights = torch.pow(torch.square(scores) + 1e-12, gamma).detach()
        return self.gl_reg * torch.sum(scores / torch.clamp(weights, min=1e-8))

    def grn_reg(self, grn: torch.Tensor, params: Optional[Params] = None) -> torch.Tensor:
        """The weight mass on edges absent from a prior graph ``grn`` (d, d),
        grn[i, j] = 1 for an allowed edge i -> j."""
        return torch.sum(torch.abs(self._fc1_groups(params) * (1.0 - grn[:, :, None])))


def make_ensemble(module: nn.Module, n_members: int
                  ) -> Tuple[Callable[[torch.Generator], Dict[str, torch.Tensor]], Callable]:
    """A deep ensemble as a stacked parameter axis over one module.

    Returns ``init_fn(generator) -> stacked`` (each parameter of ``module``
    drawn ``n_members`` times by ``reset_parameters`` from the CPU
    ``generator`` and stacked on a new leading axis, on the module's device)
    and ``apply_fn(stacked, *args) -> (members, ...)``, the module run once a
    member by ``torch.func.vmap`` over ``functional_call``.
    """

    def init_fn(generator: torch.Generator) -> Dict[str, torch.Tensor]:
        members = []
        for _ in range(n_members):
            m = copy.deepcopy(module)
            m.reset_parameters(generator)
            members.append({k: v.detach() for k, v in m.named_parameters()})
        return {k: torch.stack([p[k] for p in members]) for k in members[0]}

    def apply_fn(stacked: Mapping[str, torch.Tensor], *args) -> torch.Tensor:
        def one(params):
            return torch.func.functional_call(module, params, args)

        return torch.func.vmap(one)(dict(stacked))

    return init_fn, apply_fn


class DeepSet(_Seeded):
    """A permutation-invariant set encoder (n, set, in_dim) -> (n, out_dim):
    phi on each element (ReLU layers), sum over the set, rho (ReLU layers),
    a linear output. Layers ``Dense_0``, ... in flax's order."""

    def __init__(self, in_dim: int, phi_dims: Sequence[int] = (64, 64),
                 rho_dims: Sequence[int] = (64,), out_dim: int = 64, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.n_phi, self.n_rho = len(phi_dims), len(rho_dims)
        widths = [in_dim, *phi_dims, *rho_dims, out_dim]
        for i in range(len(widths) - 1):
            setattr(self, f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))
        self._init(seed, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.n_phi + self.n_rho + 1):
            _dense_init(getattr(self, f"Dense_{i}"), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer = 0
        h = x
        for _ in range(self.n_phi):
            h = F.relu(getattr(self, f"Dense_{layer}")(h))
            layer += 1
        pooled = torch.sum(h, dim=-2)
        for _ in range(self.n_rho):
            pooled = F.relu(getattr(self, f"Dense_{layer}")(pooled))
            layer += 1
        return getattr(self, f"Dense_{layer}")(pooled)


class HyperLocallyConnected(_Seeded):
    """A locally-connected layer whose per-sample weights and biases are
    generated from a context (n, context_dim) by two linear maps,
    ``hyper_w`` and ``hyper_b``: (n, d, m_in) -> (n, d, m_out)."""

    def __init__(self, num_vars: int, m_in: int, m_out: int, context_dim: int,
                 use_bias: bool = True, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.num_vars, self.m_in, self.m_out = num_vars, m_in, m_out
        self.hyper_w = nn.Linear(context_dim, num_vars * m_in * m_out)
        self.hyper_b = nn.Linear(context_dim, num_vars * m_out) if use_bias else None
        self._init(seed, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        _dense_init(self.hyper_w, generator)
        if self.hyper_b is not None:
            _dense_init(self.hyper_b, generator)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        d = self.num_vars
        w = self.hyper_w(context).reshape(-1, d, self.m_in, self.m_out)
        out = torch.einsum("ndm,ndmo->ndo", x, w)
        if self.hyper_b is not None:
            out = out + self.hyper_b(context).reshape(-1, d, self.m_out)
        return out


class HyperMLPODEF(_Seeded):
    """MLPODEF whose hidden locally-connected layer is generated from a
    context (for example a DeepSet encoding of the intervened variables)."""

    def __init__(self, dims: Sequence[int], context_dim: int = 16, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.dims, self.context_dim = list(dims), context_dim
        d, k = dims[0], dims[1]
        self.fc1 = nn.Linear(d, d * k)
        self.hyper_fc2 = HyperLocallyConnected(d, k, dims[-1], context_dim)
        self._init(seed, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        _dense_init(self.fc1, generator)
        self.hyper_fc2.reset_parameters(generator)

    def forward(self, t, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        d, k = self.dims[0], self.dims[1]
        h = F.elu(self.fc1(x).reshape(-1, d, k))
        return self.hyper_fc2(h, context)[..., 0]


class BayesMLPODEF(_Seeded):
    """MLPODEF with learnable per-edge Bernoulli logits gating fc1's weight
    groups; with a generator (or the uniforms ``u`` (d, d) in
    (1e-6, 1 - 1e-6)) the gate is a Gumbel-sigmoid sample, a distribution
    over graphs, else the sigmoid of the logits. ``fc1_kernel`` keeps flax's
    (d, d * k) layout."""

    def __init__(self, dims: Sequence[int], temperature: float = 0.5, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.dims, self.temperature = list(dims), temperature
        d, k = dims[0], dims[1]
        self.edge_logits = nn.Parameter(torch.empty(d, d))
        self.fc1_kernel = nn.Parameter(torch.empty(d, d * k))
        self.fc1_bias = nn.Parameter(torch.empty(d, k))
        _hidden_layers(self, dims, k, d)
        self._init(seed, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        d = self.dims[0]
        self.edge_logits.zero_()
        self.fc1_kernel.copy_(_lecun(self.fc1_kernel.shape, d, generator))
        self.fc1_bias.zero_()
        for i in range(len(self.dims) - 2):
            getattr(self, f"fc2_{i}").reset_parameters(generator)

    def forward(self, t, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
        d, k = self.dims[0], self.dims[1]
        logits = self.edge_logits
        if generator is not None or u is not None:
            if u is None:
                u = torch.rand((d, d), generator=generator, device=x.device) * (1 - 2e-6) + 1e-6
            g = torch.log(u) - torch.log1p(-u)
            gate = torch.sigmoid((logits + g) / self.temperature)
        else:
            gate = torch.sigmoid(logits)
        wg = self.fc1_kernel.reshape(d, d, k) * gate[:, :, None]
        h = torch.einsum("ni,ijk->njk", x, wg) + self.fc1_bias[None]
        return _run_hidden(self, h, len(self.dims) - 2)

    def edge_probs(self) -> torch.Tensor:
        return torch.sigmoid(self.edge_logits)


class DibsMLPODEF(_Seeded):
    """A DiBS-style variational graph posterior over fc1's structure.

    fc1's weight is factorised through latent node embeddings, W (r, d) "in"
    and V (r, d * k) "out" factors, each with a mean-field Gaussian posterior
    (softplus std); with a generator (or the standard normals ``noise`` =
    (for W, for V)) the forward pass samples the factors, else it uses their
    means. The latent graph Z[i, j] is the mean over the k hidden units of
    (W^T V)[i, j k:(j + 1) k]; edge probabilities are
    sigmoid(alpha * iter_num * Z); ``h_acyclic`` is the NOTEARS polynomial
    tr((I + G / d)^d) - d. The readouts take this module's parameters or
    ``params`` (see :class:`MLPODEF`). Particles are ensemble members
    (:func:`make_ensemble`), transported by :func:`svgd_update`.
    """

    def __init__(self, dims: Sequence[int], rank: int = 16, alpha: float = 0.1,
                 init_log_std: float = -3.0, eps: float = 1e-8, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.dims, self.rank, self.alpha = list(dims), rank, alpha
        self.init_log_std, self.eps = init_log_std, eps
        d, k = dims[0], dims[1]
        self.w_mean = nn.Parameter(torch.empty(rank, d))
        self.v_mean = nn.Parameter(torch.empty(rank, d * k))
        self.w_isp_std = nn.Parameter(torch.empty(rank, d))
        self.v_isp_std = nn.Parameter(torch.empty(rank, d * k))
        self.fc1_bias = nn.Parameter(torch.empty(d, k))
        _hidden_layers(self, dims, k, d)
        self._init(seed, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.w_mean.copy_(_lecun(self.w_mean.shape, self.rank, generator))
        self.v_mean.copy_(_lecun(self.v_mean.shape, self.rank, generator))
        self.w_isp_std.fill_(self.init_log_std)
        self.v_isp_std.fill_(self.init_log_std)
        self.fc1_bias.zero_()
        for i in range(len(self.dims) - 2):
            getattr(self, f"fc2_{i}").reset_parameters(generator)

    def forward(self, t, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        d, k = self.dims[0], self.dims[1]
        W, V = self.w_mean, self.v_mean
        if generator is not None or noise is not None:
            if noise is None:
                noise = tuple(torch.randn(p.shape, generator=generator, device=p.device)
                              for p in (W, V))
            W = W + noise[0] * (F.softplus(self.w_isp_std) + self.eps)
            V = V + noise[1] * (F.softplus(self.v_isp_std) + self.eps)
        weight = (W.transpose(-1, -2) @ V).reshape(d, d, k)
        h = torch.einsum("ni,ijk->njk", x, weight) + self.fc1_bias[None]
        return _run_hidden(self, h, len(self.dims) - 2)

    def latent_z(self, params: Optional[Params] = None) -> torch.Tensor:
        d, k = self.dims[0], self.dims[1]
        W, V = _param(self, params, "w_mean"), _param(self, params, "v_mean")
        z = W.transpose(-1, -2) @ V
        return z.reshape(z.shape[:-2] + (d, d, k)).mean(-1)

    def edge_probs(self, params: Optional[Params] = None, iter_num: float = 1.0
                   ) -> torch.Tensor:
        return torch.sigmoid(self.alpha * iter_num * self.latent_z(params))

    def h_acyclic(self, params: Optional[Params] = None, iter_num: float = 1.0
                  ) -> torch.Tensor:
        """tr((I + G / d)^d) - d: zero iff the soft graph G is acyclic."""
        d = self.dims[0]
        G = self.edge_probs(params, iter_num)
        M = torch.eye(d, dtype=G.dtype, device=G.device) + G / d
        return torch.diagonal(torch.linalg.matrix_power(M, d), dim1=-2, dim2=-1).sum(-1) - d

    def sample_structures(self, generator: Optional[torch.Generator], n_structures: int,
                          params: Optional[Params] = None, iter_num: float = 1.0,
                          u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``n_structures`` binary graphs ~ Bernoulli(edge_probs); ``u`` the
        (n_structures, d, d) uniforms."""
        p = self.edge_probs(params, iter_num)
        if u is None:
            u = torch.rand((n_structures,) + tuple(p.shape), generator=generator,
                           device=p.device)
        return (u.to(p.device) < p[None]).float()

    def kl_to_prior(self, params: Optional[Params] = None, prior_log_sigma: float = 0.0
                    ) -> torch.Tensor:
        """KL(q || N(0, sigma_p^2)) of the mean-field Gaussians of both factors."""
        total = 0.0
        sp = math.exp(prior_log_sigma)
        for m, s in (("w_mean", "w_isp_std"), ("v_mean", "v_isp_std")):
            mu = _param(self, params, m)
            sigma = F.softplus(_param(self, params, s)) + self.eps
            total = total + torch.sum(torch.log(sp / sigma) + (sigma ** 2 + mu ** 2)
                                      / (2.0 * sp ** 2) - 0.5)
        return total


def svgd_update(particles: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                bandwidth: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """One SVGD transport direction for a particle posterior.

    ``particles`` and ``grads`` map names to tensors with a leading particle
    axis P. Each particle's vector concatenates its own slice of every leaf,
    in the mapping's order. Returns phi with the same names and shapes:
    phi_i = mean_j [k(x_j, x_i) grad_j + grad_{x_j} k(x_j, x_i)], with an RBF
    kernel and, when ``bandwidth`` is None, the median heuristic: the median
    of the P^2 squared distances by ``torch.quantile`` (the mean of the two
    middle values of an even count, as ``jnp.median``).
    """
    names = list(particles)
    P = particles[names[0]].shape[0]
    X = torch.cat([particles[k].reshape(P, -1) for k in names], dim=1)
    G = torch.cat([grads[k].reshape(P, -1) for k in names], dim=1)
    sq = torch.sum((X[:, None] - X[None]) ** 2, dim=-1)
    if bandwidth is None:
        med = torch.quantile(sq.reshape(-1), 0.5)
        bandwidth = torch.sqrt(0.5 * med / math.log(P + 1.0) + 1e-12)
    K = torch.exp(-sq / (2.0 * bandwidth ** 2 + 1e-12))
    attract = K @ G
    repulse = (torch.sum(K, dim=1, keepdim=True) * X - K @ X) / (bandwidth ** 2 + 1e-12)
    phi = (attract + repulse) / P
    out, col = {}, 0
    for k in names:
        width = particles[k][0].numel()
        out[k] = phi[:, col:col + width].reshape(particles[k].shape)
        col += width
    return out
