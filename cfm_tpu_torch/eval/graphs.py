"""Graph-inference metrics: SHD, Bayesian SHD, posterior coverage, AUC and
AP over an inferred gene-regulatory adjacency (the port's own copy of
``cfm_tpu/eval/graphs.py``, which imports no JAX either).

Rows of ``true_graph`` with a negative first entry are "deidentifiable"
duplicate variables whose outgoing edges fold onto the row ``-(value + 1)``
before comparison. ``compare_graphs``' ROC AUC and average precision are
computed here in numpy, as scikit-learn defines them (tied scores take their
average rank; the precision is summed stepwise over the distinct
thresholds), so the port needs no scikit-learn.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _fold_deidentified(true_graph: np.ndarray, estimated_graph: np.ndarray):
    true_graph = np.asarray(true_graph).squeeze().astype(int)
    estimated_graph = np.asarray(estimated_graph).squeeze().astype(float)
    var_maps = np.minimum(0, true_graph)[:, 0]
    var_mask = var_maps < 0
    vars_to_deidentify = -(var_maps[var_mask] + 1)
    folded = estimated_graph[~var_mask].copy()
    for i, v in enumerate(vars_to_deidentify):
        folded[v] += estimated_graph[var_mask][i]
    return true_graph[~var_mask], folded


def structural_hamming_distance(true_graph: np.ndarray, estimated_graph: np.ndarray) -> float:
    """SHD with deidentified-variable folding (evaluation.py:7-30)."""
    t, e = _fold_deidentified(true_graph, estimated_graph)
    return float(np.sum(np.abs(t - e)))


def compare_graphs_bayesian_shd(
    true_graph: np.ndarray, estimated_graphs: Sequence[np.ndarray]
) -> Tuple[float, float]:
    """(mean SHD, mean thresholded SHD) over a posterior sample of graphs
    (evaluation.py:32-42)."""
    shd = float(np.mean([structural_hamming_distance(true_graph, g) for g in estimated_graphs]))
    tshd = float(
        np.mean(
            [
                structural_hamming_distance(true_graph, (np.asarray(g) > 0.5).astype(float))
                for g in estimated_graphs
            ]
        )
    )
    return shd, tshd


def graph_shd(W_true: np.ndarray, W_est: np.ndarray) -> int:
    """Graph-aware structural Hamming distance (evaluation.py:195-207):
    extra + missing undirected edges plus reversed directed edges — a
    reversed edge counts ONE, not one-missing-plus-one-extra."""
    W_true = np.asarray(W_true)
    W_est = np.asarray(W_est)
    pred = np.flatnonzero(W_est != 0)
    cond = np.flatnonzero(W_true)
    cond_reversed = np.flatnonzero(W_true.T)
    extra = np.setdiff1d(pred, cond, assume_unique=True)
    reverse = np.intersect1d(extra, cond_reversed, assume_unique=True)
    pred_lower = np.flatnonzero(np.tril(W_est + W_est.T))
    cond_lower = np.flatnonzero(np.tril(W_true + W_true.T))
    extra_lower = np.setdiff1d(pred_lower, cond_lower, assume_unique=True)
    missing_lower = np.setdiff1d(cond_lower, pred_lower, assume_unique=True)
    return int(len(extra_lower) + len(missing_lower) + len(reverse))


def _average_ranks(scores: np.ndarray) -> np.ndarray:
    """1-based ranks of ``scores``, tied values sharing their average rank."""
    _, inverse, counts = np.unique(scores, return_inverse=True, return_counts=True)
    ends = np.cumsum(counts)
    return ((ends - counts + 1 + ends) / 2.0)[inverse]


def roc_auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """The area under the ROC curve of binary labels ``y_true`` (both classes
    present) against ``scores``: the Mann-Whitney statistic of the positives'
    average ranks, which counts a tied (positive, negative) pair as half."""
    y = np.asarray(y_true, float).ravel() != 0
    ranks = _average_ranks(np.asarray(scores, float).ravel())
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def average_precision(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Average precision: sum over the distinct score thresholds, highest
    first, of (recall_k - recall_{k-1}) * precision_k."""
    y = (np.asarray(y_true, float).ravel() != 0).astype(float)
    s = np.asarray(scores, float).ravel()
    order = np.argsort(-s, kind="mergesort")
    s, y = s[order], y[order]
    last = np.r_[np.flatnonzero(np.diff(s)), s.size - 1]  # the end of each tie group
    tps = np.cumsum(y)[last]
    precision = tps / (last + 1)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def compare_graphs(true_graph: np.ndarray, estimated_graph: np.ndarray) -> dict:
    """The single-graph metrics: tpr, fdr, f1 and specificity of the
    binarised adjacencies, the graph-aware SHD (a reversed edge counts one)
    and the SHD of the estimate thresholded at 0.5, and AUC and AP over the
    whole clamped matrix when both classes occur. Deidentified rows
    (negative first column) are clamped to 0. ``auroc`` is an alias of
    ``auc``."""
    t = np.maximum(0, np.asarray(true_graph, float))
    e = np.asarray(estimated_graph, float)
    tam = (t != 0.0).astype(float)
    eam = (e != 0.0).astype(float)
    num_edges = int(tam.sum())
    tp = int(((tam + eam) == 2).sum())
    fp = int(((tam - eam) < 0).sum())
    tn = int(((tam + eam) == 0).sum())
    fn = num_edges - tp
    precision = tp / (tp + fp) if tp + fp else 0.0
    tpr = tp / (tp + fn) if tp + fn else 0.0
    specificity = tn / (tn + fp) if tn + fp else 0.0
    f1 = 2 * precision * tpr / (precision + tpr) if precision + tpr else 0.0
    fdr = fp / (fp + tp) if fp + tp else 0.0
    out = {
        "tpr": tpr, "fdr": fdr, "f1": f1, "specificity": specificity,
        "shd": float(graph_shd(t, e)),
        "tshd": float(graph_shd(t, (e > 0.5).astype(float))),
    }
    y_true = tam.flatten()
    if 0 < y_true.sum() < y_true.size:
        out["auc"] = roc_auc(y_true, e.flatten())
        out["ap"] = average_precision(y_true, e.flatten())
        out["auroc"] = out["auc"]
    return out


def compare_graphs_bayesian_dist(
    true_graph: np.ndarray, estimated_graphs: Sequence[np.ndarray]
) -> Tuple[int, int, int, dict, dict]:
    """Posterior-distance accounting over a sample of graphs
    (evaluation.py:45-91).

    A posterior sample is "admissible" when, after folding each
    deidentified duplicate row onto its canonical variable, the folded rows
    of every ALIASED canonical variable match the true rows exactly
    (Hamming 0 on those rows). Each sample is keyed by its undetermined
    block — the alias rows plus the aliased canonical rows — so distinct
    assignments of edges among the duplicates count as distinct graphs.

    Returns ``(seen_admissible, total_admissible, unique_admissible,
    admissible_count, sample_count)`` where the counts are
    ``{key tuple: multiplicity}`` dicts, and ``total_admissible`` is the
    number of edge-to-copy assignments consistent with the true graph:
    prod over aliased variables v of ``(n_copies_v + 1) ** out_degree_v``.
    """
    true_graph = np.asarray(true_graph).squeeze().astype(int)
    var_maps = np.minimum(0, true_graph)[:, 0]
    var_mask = var_maps < 0
    vars_to_deidentify = -(var_maps[var_mask] + 1)
    unique, counts = np.unique(vars_to_deidentify, return_counts=True)

    admissible_count: dict = {}
    sample_count: dict = {}
    key_mask = var_mask.copy()
    key_mask[unique] = True
    for g in estimated_graphs:
        g = np.asarray(g).squeeze().astype(float)
        folded = g[~var_mask].copy()
        for i, v in enumerate(vars_to_deidentify):
            folded[v] += g[var_mask][i]
        hamming = np.sum(np.abs(true_graph[unique] - folded[unique]))
        key = tuple(g[key_mask].flatten())
        sample_count[key] = sample_count.get(key, 0) + 1
        if hamming == 0:
            admissible_count[key] = admissible_count.get(key, 0) + 1

    unique_admissible = len(admissible_count)
    total_targets = np.sum(true_graph[unique], axis=1)
    total_admissible = 1
    for c, t in zip(counts, total_targets):
        total_admissible *= (int(c) + 1) ** int(t)
    # The reference returns len(list(counter)) for both "seen" and "unique"
    # (evaluation.py:78-79) — reproduced for drop-in parity.
    return (
        unique_admissible,
        int(total_admissible),
        unique_admissible,
        admissible_count,
        sample_count,
    )


def compare_graphs_bayesian_cover(
    true_graph: np.ndarray, estimated_graphs: Sequence[np.ndarray]
) -> float:
    """Fraction of the admissible-graph space covered by the posterior
    sample (evaluation.py:93-103): unique admissible graphs seen divided by
    the total number of admissible edge-to-copy assignments."""
    _, total_admissible, unique_admissible, _, _ = compare_graphs_bayesian_dist(
        true_graph, estimated_graphs
    )
    return unique_admissible / total_admissible


def compare_graph_distribution(
    true_graph: np.ndarray, estimated_graphs: Sequence[np.ndarray]
) -> Tuple[float, List[float], float]:
    """Distribution-shape diagnostics over the admissible posterior mass
    (evaluation.py:118-150): KL of the admissible-sample distribution to
    uniform (bits), the admissible mass per unique graph as a fraction of
    ALL samples, and the same entropy gap computed against the total
    sample count."""
    _, _, _, admissible_count, sample_count = compare_graphs_bayesian_dist(
        true_graph, estimated_graphs
    )

    def neg_entropy(ps):
        return float(sum(p * np.log2(p) for p in ps if p > 0.0))

    adm_total = float(sum(admissible_count.values()))
    dist_admissible = [v / adm_total for v in admissible_count.values()]
    kl_unif = float(np.log2(len(admissible_count))) + neg_entropy(dist_admissible)

    all_total = float(sum(sample_count.values()))
    admissible_proportion = [v / all_total for v in admissible_count.values()]
    kl_proportion = float(np.log2(len(sample_count))) + neg_entropy(admissible_proportion)
    return kl_unif, admissible_proportion, kl_proportion


def compute_graphs_bayesian_diversity(
    graphs: np.ndarray, seed: int = 0
) -> float:
    """Node-wise posterior variance normalized by the variance of iid
    Bernoulli(0.5) graphs of the same shape (evaluation.py:154-167).
    ``seed`` pins the Bernoulli draw (the reference uses global state)."""
    graphs = np.asarray(graphs, float)
    rng = np.random.default_rng(seed)
    ber = rng.binomial(1, 0.5, size=graphs.shape)
    return float(np.sum(np.var(graphs, axis=0)) / np.sum(np.var(ber, axis=0)))


def compute_graphs_sparsity(graphs: np.ndarray) -> float:
    """1 - mean of the 0-rounded adjacency (evaluation.py:170-179)."""
    return float(1.0 - np.mean(np.around(np.asarray(graphs, float), 0)))
