"""Hierarchical binary BoW vocabulary and the loop / relocalization
candidate scores.

Port of ``active_orb_slam2_tpu/models/vocabulary.py`` (DBoW2's tree of
binary k-medians over 256-bit ORB descriptors, tf-idf BoW vectors, L1
scores, the ``KeyFrameDatabase`` group rule).  The training and the
DBoW2 text format are host numpy, copied from the JAX module (which
imports ``jax``); the tree descent and the scores are tensor ops.
Descriptors are int32 words with the uint32 bits, as everywhere in the
port; popcount is ``map_state.py::popcount32``.
"""

from typing import NamedTuple

import numpy as np
import torch

from active_orb_slam2_tpu_torch.models.map_state import popcount32
from active_orb_slam2_tpu_torch.ops.topk import stable_topk

DENSE_MAX_WORDS = 4096      # larger vocabularies score through sparse BoW


class Vocabulary(NamedTuple):
    """Explicit k-ary tree (non-full trees too).  ``children[0]`` holds the
    root's children, ``children[i + 1]`` node i's (node ids or -1)."""
    centers: torch.Tensor   # [n_nodes, 8] int32 (uint32 bits)
    children: torch.Tensor  # [n_nodes + 1, k] int32
    word_id: torch.Tensor   # [n_nodes] int32, >= 0 at leaves
    idf: torch.Tensor       # [n_words] float32
    k: int
    depth: int

    @property
    def n_words(self):
        return self.idf.shape[0]

    def to(self, device):
        return self._replace(centers=self.centers.to(device),
                             children=self.children.to(device),
                             word_id=self.word_id.to(device),
                             idf=self.idf.to(device))


def _from_numpy(centers, children, word_id, idf, k, depth) -> Vocabulary:
    return Vocabulary(
        centers=torch.from_numpy(np.ascontiguousarray(centers, np.uint32)
                                 .view(np.int32)),
        children=torch.from_numpy(np.asarray(children, np.int32)),
        word_id=torch.from_numpy(np.asarray(word_id, np.int32)),
        idf=torch.from_numpy(np.asarray(idf, np.float32)), k=k, depth=depth)


# ----------------------------------------------------------------- training

def _majority_center(desc_bits, weights):
    """Bitwise weighted majority -> packed uint32[8]."""
    s = (desc_bits * weights[:, None]).sum(0)
    maj = (2 * s > weights.sum()).astype(np.uint32)
    lanes = maj.reshape(8, 32)
    return (lanes << np.arange(32, dtype=np.uint32)).sum(1, dtype=np.uint32)


def _unpack_np(desc):
    bits = (desc[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(desc.shape[0], 256)


def _hamming_np(a, b):
    """[M, 8] x [N, 8] uint32 -> [M, N] popcounts."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _full_tree_children(k: int, depth: int):
    """Children table and word ids of a full k-ary tree whose nodes are
    level-major rows."""
    offsets = [0]
    for level in range(depth):
        offsets.append(offsets[-1] + k ** (level + 1))
    n_nodes = offsets[-1]
    children = np.full((n_nodes + 1, k), -1, np.int32)
    children[0] = np.arange(k)
    for level in range(depth - 1):
        base, nxt = offsets[level], offsets[level + 1]
        n = k ** (level + 1)
        rows = np.arange(base, base + n)
        children[rows + 1] = (nxt + np.arange(n)[:, None] * k
                              + np.arange(k)[None, :])
    word_id = np.full((n_nodes,), -1, np.int32)
    word_id[offsets[depth - 1]:] = np.arange(k ** depth)
    return children, word_id


def train_vocabulary(descriptors, k: int = 10, depth: int = 3,
                     iters: int = 8, seed: int = 0) -> Vocabulary:
    """Hierarchical binary k-medians on the host (DBoW2's build, trimmed),
    the JAX package's algorithm and random stream: ``descriptors`` [N, 8]
    uint32 (or int32 bits).  A full tree; empty branches get random
    centers.  Returns a CPU vocabulary."""
    rng = np.random.default_rng(seed)
    desc = np.ascontiguousarray(descriptors).view(np.uint32)
    bits = _unpack_np(desc)
    levels = []
    assign = np.zeros(desc.shape[0], dtype=np.int64)
    for level in range(depth):
        n_parents = k ** level
        centers = np.zeros((n_parents * k, 8), np.uint32)
        new_assign = np.zeros_like(assign)
        for parent in range(n_parents):
            sel = np.where(assign == parent)[0]
            if len(sel) == 0:
                centers[parent * k:(parent + 1) * k] = rng.integers(
                    0, 2**32, (k, 8), dtype=np.uint32)
                continue
            sub = desc[sel]
            sub_bits = bits[sel]
            picks = rng.choice(len(sel), size=min(k, len(sel)), replace=False)
            c = sub[picks]
            if len(picks) < k:
                c = np.concatenate([c, rng.integers(
                    0, 2**32, (k - len(picks), 8), dtype=np.uint32)])
            for _ in range(iters):
                a = _hamming_np(sub, c).argmin(1)
                for j in range(k):
                    mask = a == j
                    if mask.any():
                        c[j] = _majority_center(sub_bits[mask],
                                                np.ones(mask.sum()))
            a = _hamming_np(sub, c).argmin(1)
            centers[parent * k:(parent + 1) * k] = c
            new_assign[sel] = parent * k + a
        levels.append(centers)
        assign = new_assign
    n_words = k ** depth
    df = np.bincount(assign, minlength=n_words).astype(np.float32)
    idf = np.log(float(len(assign) + n_words) / (df + 1.0))
    children, word_id = _full_tree_children(k, depth)
    return _from_numpy(np.concatenate(levels, axis=0), children, word_id, idf,
                       k, depth)


# -------------------------------------------------------------- text format

def load_text_vocabulary(path: str) -> Vocabulary:
    """Parse a DBoW2 text vocabulary (``TemplatedVocabulary::
    loadFromTextFile``): header ``k L scoring weighting``, then one line
    per node in id order, ``parent is_leaf b0..b31 weight``; word ids go
    to leaves in line order."""
    with open(path) as f:
        header = f.readline().split()
        k, depth = int(header[0]), int(header[1])
        vals = np.array(f.read().split(), dtype=np.float64).reshape(-1, 35)
    parents = vals[:, 0].astype(np.int64)
    is_leaf = vals[:, 1] != 0
    centers = np.ascontiguousarray(vals[:, 2:34].astype(np.uint8)).view(
        np.uint32)
    n_nodes = len(vals)
    children = np.full((n_nodes + 1, k), -1, np.int32)
    node_ids = np.arange(n_nodes, dtype=np.int32)
    # child slot = rank within the parent's group, in file order
    order = np.argsort(parents, kind="stable")
    sp = parents[order]
    first_of = np.searchsorted(sp, np.arange(n_nodes + 2))
    children[sp, np.arange(n_nodes) - first_of[sp]] = node_ids[order]
    word_id = np.full(n_nodes, -1, np.int32)
    word_id[node_ids[is_leaf]] = np.arange(int(is_leaf.sum()), dtype=np.int32)
    return _from_numpy(centers, children, word_id,
                       vals[is_leaf, 34].astype(np.float32), k, depth)


def save_text_vocabulary(voc: Vocabulary, path: str):
    """Write the DBoW2 text format; round-trips with
    :func:`load_text_vocabulary` (and with the JAX package's)."""
    centers = voc.centers.cpu().numpy().view(np.uint32)
    children = voc.children.cpu().numpy()
    word_id = voc.word_id.cpu().numpy()
    idf = voc.idf.cpu().numpy()
    n_nodes = centers.shape[0]
    # children row r is the root (0) or node r - 1, the file's numbering
    parent = np.zeros(n_nodes, np.int64)
    for row in range(children.shape[0]):
        ch = children[row]
        parent[ch[ch >= 0]] = row
    bytes_view = centers.view(np.uint8).reshape(n_nodes, 32)
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.depth} 0 0\n")
        for i in range(n_nodes):
            w = float(idf[word_id[i]]) if word_id[i] >= 0 else 0.0
            f.write(" ".join(
                [str(parent[i]), "1" if word_id[i] >= 0 else "0"]
                + [str(int(b)) for b in bytes_view[i]] + [repr(w)]) + "\n")


# ------------------------------------------------------------------- descent

def _descend(voc: Vocabulary, desc):
    """Tree descent of descriptors [..., F, 8] -> leaf word ids [..., F]:
    per level the Hamming argmin over the children (first on ties), an
    early leaf loops on itself."""
    cur = torch.zeros(desc.shape[:-1], dtype=torch.long, device=desc.device)
    big = torch.iinfo(torch.int32).max
    for _ in range(voc.depth):
        ch = voc.children[cur].long()                        # [..., F, k]
        ok = ch >= 0
        cents = voc.centers[torch.clamp(ch, min=0)]          # [..., F, k, 8]
        d = popcount32(desc[..., None, :] ^ cents).sum(-1)
        d = torch.where(ok, d, big)
        best = torch.argmin(d, dim=-1, keepdim=True)
        nxt = torch.gather(ch, -1, best)[..., 0] + 1
        cur = torch.where(ok.any(-1), nxt, cur)
    return torch.clamp(voc.word_id[torch.clamp(cur - 1, min=0)], min=0)


def transform(voc: Vocabulary, desc, valid):
    """Descriptors [..., F, 8] -> (word ids [..., F], dense L1-normalized
    tf-idf BoW [..., W])."""
    words = _descend(voc, desc)
    W = voc.n_words
    lead = words.shape[:-1]
    rows = torch.arange(int(np.prod(lead)), device=desc.device)[:, None] * W
    counts = torch.zeros(rows.shape[0] * W, device=desc.device).index_add_(
        0, (rows + words.reshape(rows.shape[0], -1)).reshape(-1),
        valid.reshape(-1).to(torch.float32)).view(lead + (W,))
    tfidf = counts * voc.idf
    norm = torch.clamp(tfidf.abs().sum(-1, keepdim=True), min=1e-9)
    return words, tfidf / norm


def transform_sparse(voc: Vocabulary, desc, valid):
    """Descriptors [..., F, 8] -> fixed-width sparse BoW: (words [..., F],
    unique words [..., F] ascending and -1 padded at the end, their
    L1-normalized weights [..., F]).  Exact for any vocabulary size."""
    words = _descend(voc, desc)
    F = desc.shape[-2]
    W = voc.n_words
    imax = torch.iinfo(torch.int32).max
    skey = torch.sort(torch.where(valid, words, W), dim=-1).values
    first = torch.cat([torch.ones_like(skey[..., :1], dtype=torch.bool),
                       skey[..., 1:] != skey[..., :-1]], -1) & (skey < W)
    seg = torch.clamp(torch.cumsum(first.to(torch.int32), -1) - 1, min=0)
    tf = torch.zeros(skey.shape, device=desc.device).scatter_add_(
        -1, seg.long(), (skey < W).to(torch.float32))
    uniq = torch.where(first, skey, -1)
    uniq = torch.sort(torch.where(uniq < 0, imax, uniq), dim=-1).values
    n_uniq = first.sum(-1, keepdim=True)
    uniq = torch.where(torch.arange(F, device=desc.device) < n_uniq, uniq, -1)
    w = tf * torch.where(uniq >= 0, voc.idf[torch.clamp(uniq, min=0)], 0.0)
    norm = torch.clamp(w.abs().sum(-1, keepdim=True), min=1e-9)
    return words, uniq.to(torch.int32), w / norm


def l1_score(bow_q, bow_db):
    """DBoW2 L1 similarity 1 - 0.5 |q - d|_1 of L1-normalized BoWs;
    bow_db [K, W] -> [K]."""
    return 1.0 - 0.5 * (bow_q[None, :] - bow_db).abs().sum(-1)


def l1_score_sparse(n_words: int, q_words, q_weights, db_words, db_weights):
    """The same score for sparse BoWs: sum over shared words of
    min(q_i, d_i), with the query scattered densely once.  q_* [F];
    db_* [K, F] (-1 padded).  Returns [K]."""
    qd = torch.zeros(n_words, device=q_words.device).index_add_(
        0, torch.clamp(q_words, min=0).long(),
        torch.where(q_words >= 0, q_weights, 0.0))
    g = torch.where(db_words >= 0, qd[torch.clamp(db_words, min=0).long()], 0.0)
    return torch.minimum(g, db_weights).sum(-1)


def detect_candidates_from_scores(s, kf_valid, covis_mask, min_score,
                                  covis_weights=None, top_n: int = 10):
    """``KeyFrameDatabase::DetectLoopCandidates``'s group rule on scores
    [K]: eligible keyframes (valid, not covisible with the query, score
    >= min_score) accepted where their group score (own plus their top-n
    covisible eligible ones) reaches 0.75 of the best.  Returns (s,
    accept [K])."""
    eligible = kf_valid & ~covis_mask & (s >= min_score)
    s_eff = torch.where(eligible, s, 0.0)
    if covis_weights is None:
        return s, eligible
    topw, topi = stable_topk(covis_weights, top_n)           # [K, top_n]
    member_ok = (topw > 0) & eligible[topi]
    acc = s_eff + torch.where(member_ok, s_eff[topi], 0.0).sum(-1)
    best_acc = acc.max()
    return s, eligible & (acc >= 0.75 * best_acc) & (best_acc > 0)


def detect_candidates(bow_q, kf_bow, kf_valid, covis_mask, min_score,
                      covis_weights=None, top_n: int = 10):
    """``DetectLoopCandidates`` on dense BoWs: (scores [K], accept [K])."""
    return detect_candidates_from_scores(
        l1_score(bow_q, kf_bow), kf_valid, covis_mask, min_score,
        covis_weights=covis_weights, top_n=top_n)
