"""The plain reference of a Random Forest fit (paper §2): what the trees of
a fit must be, worked out again from the raw rows.

It imports nothing of the program.  From the forest seed it re-derives
each tree's Poisson bag counts and every node's candidate features with a
frozen copy of the generator that defines them (`prng.py`).  It then walks
a tree the program grew, level by level, routing the in-bag rows through
the program's own conditions, and at every node it

  * sums the in-bag class weights that reach it and compares them with the
    program's node weight (`weight_gap`) and class distribution
    (`value_gap`);
  * searches every candidate column for the best split, exactly (every
    boundary between distinct in-bag values, Breiman's ordering for
    categorical columns, which is optimal for two classes) or over the
    equi-depth bucket edges in hist mode, and compares its gain with the
    gain of the split the program chose (`split_shortfall`, per unit of
    the node's weight, in float64);
  * counts what breaks the algorithm's rules (`structure_faults`): a split
    on a column that is no candidate, a threshold off the bucket edges in
    hist mode, a child under `min_records`, a split past `max_depth`, a
    node the rows never reach.

`grow` grows a tree with the same search in a lower precision, which is
the benchmark's control.  `walk` routes the rows alone and returns what
each level had to read, for the frozen work counts.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from drfbench.reference import prng

NEG = float("-inf")
CANDIDATE_SALT = 0x5EED        # candidate keys: PRNGKey(forest seed ^ salt)
SPLIT_EPS = 1e-9               # a leaf splits only on a gain above this


@dataclasses.dataclass
class Problem:
    """The rows of one fit and the rules its trees follow, on one device."""
    num: torch.Tensor           # (n, m_num) float32
    cat: torch.Tensor           # (n, m_cat) int32
    y: torch.Tensor             # (n,) int64 class ids
    arities: tuple
    classes: int
    max_depth: int
    min_records: float
    mode: str                   # "exact" | "hist"
    bins: int = 255
    impurity: str = "gini"

    def __post_init__(self):
        if self.impurity != "gini":
            raise ValueError("the reference scores gini only")
        self.edges = hist_edges(self.num, self.bins) \
            if self.mode == "hist" and self.m_num else None

    @property
    def n(self) -> int:
        return int(self.y.shape[0])

    @property
    def m_num(self) -> int:
        return int(self.num.shape[1])

    @property
    def m(self) -> int:
        return self.m_num + len(self.arities)

    @property
    def m_prime(self) -> int:
        """ceil(sqrt(m)) candidate features per node."""
        r = math.isqrt(self.m)
        return max(1, r + (0 if r * r == self.m else 1))


def hist_edges(num: torch.Tensor, bins: int) -> torch.Tensor:
    """Equi-depth bucket upper edges (m_num, bins): edge b of a column is
    its value at sorted position (b+1)·n//bins − 1, the last its max."""
    n = num.shape[0]
    pos = (torch.arange(1, bins + 1, device=num.device) * n) // bins - 1
    return torch.sort(num, dim=0).values[pos.clamp(0, n - 1)].t().contiguous()


def bag_counts(forest_seed: int, tree: int, n: int, device) -> torch.Tensor:
    """Tree `tree`'s Poisson(1) bag counts (n,) float32."""
    key = prng.fold_in(prng.prng_key(forest_seed, device), tree)
    return prng.poisson_knuth(key, 1.0, (n,)).to(torch.float32)


def candidates(forest_seed: int, tree: int, depth: int, L: int, m: int,
               m_prime: int, device) -> torch.Tensor:
    """(L, m) bool: the m' features with the largest uniforms of each of
    the level's L nodes (in frontier order), ties to the lower index."""
    key = prng.fold_in(prng.prng_key(forest_seed ^ CANDIDATE_SALT, device),
                       tree)
    key = prng.fold_in(key, depth)
    keys = prng.fold_in(key[None, :], torch.arange(L, device=device))
    g = prng.uniform(keys, (m,))
    idx = torch.sort(g, dim=-1, descending=True, stable=True).indices
    return torch.zeros_like(g, dtype=torch.bool).scatter_(
        -1, idx[:, :m_prime], True)


def weighted_gini(h: torch.Tensor) -> torch.Tensor:
    """N · gini of class-weight rows h (..., C): N − Σ h² / N, 0 at N = 0."""
    n = h.sum(-1)
    return n - torch.where(n > 0, (h * h).sum(-1) / n.clamp(min=1e-12),
                           torch.zeros_like(n))


def gain(parent, left):
    return weighted_gini(parent) - weighted_gini(left) \
        - weighted_gini(parent - left)


@dataclasses.dataclass
class TreeArrays:
    """A tree as flat node arrays, node 0 the root (the program's packed
    layout for one tree, plus its node weights)."""
    feature: np.ndarray         # (N,) int; -1 = leaf
    threshold: np.ndarray       # (N,) float32
    is_cat: np.ndarray          # (N,) bool
    cat_mask: np.ndarray        # (N, V) bool, True = left
    children: np.ndarray        # (N, 2) int
    value: np.ndarray           # (N, C) float32
    n_node: np.ndarray          # (N,) float32 in-bag weight

    @property
    def num_nodes(self) -> int:
        return int(len(self.feature))


class _Rows:
    """One tree's in-bag rows on the device, with their routing state.
    Numeric values are read as float32, or rounded to `dtype` where that is
    narrower (the control)."""

    def __init__(self, P: Problem, w: torch.Tensor, dtype=torch.float64):
        idx = torch.nonzero(w > 0).squeeze(1)
        self.P = P
        self.R = int(idx.shape[0])
        self.w = w[idx].to(dtype)
        self.y = P.y[idx]
        self.num = P.num[idx]
        self.cat = P.cat[idx].long()
        self.dtype = dtype
        self.vals = self.num if dtype == torch.float64 \
            else self.num.to(dtype).float()
        self._ranks = None

    def onehot(self) -> torch.Tensor:
        """(R, C) in-bag class weights."""
        C = self.P.classes
        return (self.y[:, None] == torch.arange(C, device=self.y.device)
                ).to(self.dtype) * self.w[:, None]

    def ranks(self) -> torch.Tensor:
        """(R, m_num): each row's position in each column's ascending
        (value, row) order."""
        if self._ranks is None:
            order = torch.argsort(self.vals, dim=0, stable=True)
            self._ranks = torch.empty_like(order).scatter_(
                0, order, torch.arange(self.R, device=order.device)[:, None]
                .expand_as(order).contiguous())
        return self._ranks


def _node_totals(rows: _Rows, loc, live, L):
    """(L, C) class weights of the rows `live` of each frontier node."""
    C = rows.P.classes
    idx = (loc.clamp(min=0) * C + rows.y)
    wt = torch.where(live, rows.w, torch.zeros_like(rows.w))
    return torch.bincount(idx, weights=wt.double(), minlength=L * C
                          ).view(L, C).to(rows.dtype)


def _seg_best(st, lengths, cut_ok, mr):
    """The best cut of each of S segments of positions, laid out segment
    after segment (st (P, C) class weights in order).  The cut after
    position i sends the segment's positions up to i left.  Returns (gain
    (S,) float64, -inf where no cut is valid; the first best position)."""
    P, dev = st.shape[0], st.device
    seg = torch.repeat_interleave(
        torch.arange(lengths.shape[0], device=dev), lengths)
    # one 1-D scan per class: on CUDA a scan along the outer dimension of
    # an (P, C) tensor runs one thread per column
    cum = torch.stack([st[:, c].contiguous().cumsum(0)
                       for c in range(st.shape[1])], 1)
    end = lengths.cumsum(0) - 1
    start = end - lengths + 1
    base = cum[start] - st[start]
    left = cum - base[seg]
    par = (cum[end] - base)[seg]
    ok = cut_ok & (left.sum(-1) >= mr) & ((par - left).sum(-1) >= mr)
    g = torch.where(ok, gain(par, left), NEG).double()
    best = torch.segment_reduce(g, "max", lengths=lengths, unsafe=True,
                                initial=NEG)
    pos = torch.arange(P, device=dev, dtype=torch.float64)
    first = torch.segment_reduce(
        torch.where(ok & (g >= best[seg]), pos, float(P)), "min",
        lengths=lengths, unsafe=True, initial=float(P)).long()
    return best, first


def _segments(cand_block):
    """The (node, column) pairs of a block of candidate columns, node-major,
    and the (L, k) map from a pair to its segment id (-1: none)."""
    nodes, cols = torch.nonzero(cand_block).unbind(1)
    seg_of = torch.full(cand_block.shape, -1, dtype=torch.int64,
                        device=cand_block.device)
    seg_of[nodes, cols] = torch.arange(nodes.shape[0],
                                       device=cand_block.device)
    return nodes, cols, seg_of


def _search(rows: _Rows, edges, loc, live, L, cand, decide=False):
    """The best split of every frontier node over its candidate columns,
    all columns of a level at once: each (node, candidate column) pair is
    a segment of positions scored by `_seg_best` (exact: the node's
    in-bag rows in value order, a cut between distinct values; hist: the
    column's buckets in order; categorical: the categories in Breiman's
    order, empty ones last).

    Returns best (L,) float64 (-inf where no split is valid), and with
    `decide` the winner: (feature (L,), threshold (L,) float32, category
    mask (L, V) bool), the first feature winning ties and the first cut
    within a column.  Arithmetic runs in `rows.dtype`."""
    P, dev, dt = rows.P, loc.device, rows.dtype
    C, mr, m_num = P.classes, P.min_records, P.m_num
    lc = loc.clamp(min=0)
    on = cand[lc] & live[:, None]                   # counted (row, column)
    st = rows.onehot()
    dense = torch.full((L, P.m), NEG, dtype=torch.float64, device=dev)
    dec = {}
    if m_num:
        nodes, cols, seg_of = _segments(cand[:, :m_num])
        S = int(nodes.shape[0])
        r, jj = torch.nonzero(on[:, :m_num]).unbind(1)
        seg = seg_of[lc[r], jj]
        if S and P.mode == "hist":
            B = P.bins
            xb = torch.searchsorted(edges[:, :-1].contiguous(),
                                    rows.vals.t().contiguous(), side="left")
            cell = seg * B + xb[jj, r]
            tab = torch.bincount(cell * C + rows.y[r],
                                 weights=rows.w[r].double(),
                                 minlength=S * B * C).view(S * B, C).to(dt)
            lengths = torch.full((S,), B, dtype=torch.int64, device=dev)
            cut_ok = torch.arange(S * B, device=dev) % B != B - 1
            g, pos = _seg_best(tab, lengths, cut_ok, mr)
            dec["num"] = (seg_of, edges[cols, pos % B])
            dense[nodes, cols] = g
        elif S:
            order = torch.argsort(seg * rows.R + rows.ranks()[r, jj])
            r, jj, seg = r[order], jj[order], seg[order]
            v = rows.vals[r, jj]
            cut_ok = torch.zeros_like(seg, dtype=torch.bool)
            cut_ok[:-1] = (seg[1:] == seg[:-1]) & (v[1:] > v[:-1])
            g, pos = _seg_best(st[r], torch.bincount(seg, minlength=S),
                               cut_ok, mr)
            nxt = (pos + 1).clamp(max=v.shape[0] - 1)
            dec["num"] = (seg_of, (v[pos.clamp(max=v.shape[0] - 1)]
                                   + v[nxt]) * 0.5)
            dense[nodes, cols] = g
    if P.arities:
        nodes, cols, seg_of = _segments(cand[:, m_num:])
        S = int(nodes.shape[0])
        if S:
            sizes = torch.as_tensor(P.arities, device=dev)[cols]
            off = sizes.cumsum(0) - sizes
            total = int(sizes.sum())
            r, jj = torch.nonzero(on[:, m_num:]).unbind(1)
            cell = off[seg_of[lc[r], jj]] + rows.cat[r, jj]
            tab = torch.bincount(cell * C + rows.y[r],
                                 weights=rows.w[r].double(),
                                 minlength=total * C).view(total, C).to(dt)
            seg_cell = torch.repeat_interleave(
                torch.arange(S, device=dev), sizes)
            cnt = tab.sum(-1)
            p = torch.where(cnt > 0, tab[:, C - 1] / cnt.clamp(min=1e-12),
                            torch.full_like(cnt, float("inf")))
            o = torch.argsort(p, stable=True)
            o = o[torch.argsort(seg_cell[o], stable=True)]
            cut_ok = torch.ones(total, dtype=torch.bool, device=dev)
            cut_ok[off + sizes - 1] = False
            g, pos = _seg_best(tab[o], sizes, cut_ok, mr)
            dec["cat"] = (seg_of, o, seg_cell, off, pos)
            dense[nodes, m_num + cols] = g
    best, feat = dense.max(1)
    if not decide:
        return best, None, None, None
    thr = torch.zeros(L, dtype=torch.float32, device=dev)
    V = max(P.arities) if P.arities else 1
    mask = torch.zeros((L, V), dtype=torch.bool, device=dev)
    ar = torch.arange(L, device=dev)
    if "num" in dec:
        seg_of, t = dec["num"]
        s = seg_of[ar, feat.clamp(max=m_num - 1)]
        thr = torch.where((feat < m_num) & (s >= 0), t[s.clamp(min=0)], thr)
    if "cat" in dec:
        seg_of, o, seg_cell, off, pos = dec["cat"]
        s = seg_of[ar, (feat - m_num).clamp(min=0)]
        win = torch.full((int(off.shape[0]),), -1, dtype=torch.int64,
                         device=dev)
        pick = (feat >= m_num) & (s >= 0)
        win[s[pick]] = ar[pick]
        q = torch.arange(o.shape[0], device=dev)
        sq = seg_cell[o]
        nd = win[sq]
        sel = (nd >= 0) & (q <= pos[sq])
        mask[nd[sel], (o - off[seg_cell[o]])[sel]] = True
    return best, feat, thr, mask


def _go_left(rows: _Rows, node, f, thr, iscat, cmask):
    """Each row's condition at its node: x <= threshold for a numeric
    feature, membership in the node's mask for a categorical one.  f, thr,
    iscat are per row; cmask (N, V) per node."""
    P = rows.P
    out = torch.zeros(rows.R, dtype=torch.bool, device=node.device)
    if P.m_num:
        x = torch.gather(rows.num, 1, f.clamp(0, P.m_num - 1)[:, None])[:, 0]
        out = x <= thr
    if P.arities:
        xc = torch.gather(rows.cat, 1, (f - P.m_num).clamp(
            0, len(P.arities) - 1)[:, None])[:, 0]
        V = cmask.shape[1]
        inside = cmask.reshape(-1)[node * V + xc.clamp(0, V - 1)] & (xc < V)
        out = torch.where(iscat, inside, out)
    return out


def _device_tree(tree: TreeArrays, device):
    t = lambda a, dt: torch.as_tensor(np.asarray(a), device=device).to(dt)
    return dict(feature=t(tree.feature, torch.int64),
                threshold=t(tree.threshold, torch.float32),
                is_cat=t(tree.is_cat, torch.bool),
                cat_mask=t(tree.cat_mask, torch.bool),
                children=t(tree.children, torch.int64),
                value=t(tree.value, torch.float64),
                n_node=t(tree.n_node, torch.float64))


def _route(rows, tr, node, frontier, loc, live, split):
    """Move the rows of split frontier nodes to their children; returns
    (node, next frontier, go_left)."""
    on = live & split[loc.clamp(min=0)]
    f = tr["feature"][node]
    gl = _go_left(rows, node, f, tr["threshold"][node], tr["is_cat"][node],
                  tr["cat_mask"])
    ch = tr["children"][node]
    node = torch.where(on, torch.where(gl, ch[:, 0], ch[:, 1]), node)
    nxt = tr["children"][frontier[split]].reshape(-1)
    return node, nxt, gl & on


def _locate(frontier, node, N):
    """(L, each row's position in the frontier or -1, that position >= 0)."""
    L = int(frontier.shape[0])
    loc_of = torch.full((N,), -1, dtype=torch.int64, device=node.device)
    loc_of[frontier] = torch.arange(L, device=node.device)
    loc = loc_of[node]
    return L, loc, loc >= 0


def check_tree(P: Problem, tree: TreeArrays, forest_seed: int,
               tree_index: int) -> dict:
    """Judge one tree the program grew: the four readings (see the module
    docstring), each the worst over the tree's nodes."""
    dev = P.y.device
    w = bag_counts(forest_seed, tree_index, P.n, dev)
    rows = _Rows(P, w)
    tr = _device_tree(tree, dev)
    N = tree.num_nodes
    out = dict(weight_gap=0.0, value_gap=0.0, split_shortfall=0.0,
               structure_faults=0)
    node = torch.zeros(rows.R, dtype=torch.int64, device=dev)
    frontier = torch.zeros(1, dtype=torch.int64, device=dev)
    seen = 1
    C, mr = P.classes, P.min_records
    for depth in range(P.max_depth + 1):
        L, loc, live = _locate(frontier, node, N)
        tot = _node_totals(rows, loc, live, L)
        Nl = tot.sum(-1)
        out["weight_gap"] = max(out["weight_gap"], float(
            (tr["n_node"][frontier] - Nl).abs().max()))
        dist = tot / Nl.clamp(min=1e-12)[:, None]
        out["value_gap"] = max(out["value_gap"], float(
            (tr["value"][frontier, :C] - dist).abs().max()))
        active = (Nl >= 2 * mr) & (depth < P.max_depth)
        split = tr["feature"][frontier] >= 0
        out["structure_faults"] += int((split & ~active).sum())
        split &= active
        if not bool(split.any()):
            break
        cand = candidates(forest_seed, tree_index, depth, L, P.m, P.m_prime,
                          dev) & active[:, None]
        best = _search(rows, P.edges, loc, live, L, cand)[0]
        node_new, nxt, gl = _route(rows, tr, node, frontier, loc, live,
                                   split)
        left = _node_totals(rows, loc, gl, L)
        g = gain(tot, left)
        f = tr["feature"][frontier]
        legal = split & cand[torch.arange(L, device=dev), f.clamp(min=0)] \
            & (left.sum(-1) >= mr) & ((tot - left).sum(-1) >= mr)
        if P.mode == "hist" and P.m_num:
            num_split = split & ~tr["is_cat"][frontier]
            e = P.edges[f.clamp(0, P.m_num - 1), :-1]
            on_edge = (e == tr["threshold"][frontier][:, None]).any(1)
            legal &= ~num_split | on_edge
        out["structure_faults"] += int((split & ~legal).sum())
        chosen = torch.where(legal, g, torch.zeros_like(g))
        short = (best.clamp(min=0) - chosen) / Nl.clamp(min=1e-12)
        out["split_shortfall"] = max(out["split_shortfall"], float(
            torch.where(active, short, torch.zeros_like(short)).max()))
        if bool(((nxt < 0) | (nxt >= N)).any()) \
                or int(torch.unique(nxt).numel()) != int(nxt.numel()):
            out["structure_faults"] += int(nxt.numel())
            break
        node, frontier = node_new, nxt
        seen += int(nxt.numel())
    out["structure_faults"] += max(0, N - seen)
    return out


def walk(P: Problem, tree: TreeArrays, forest_seed: int,
         tree_index: int) -> list:
    """What each level of one tree had to read: per depth that split,
    `rows` (L,) in-bag rows of each frontier node, `active` (L,) whether
    it could split, `cand` (L, m) its candidate features (numpy)."""
    dev = P.y.device
    rows = _Rows(P, bag_counts(forest_seed, tree_index, P.n, dev))
    tr = _device_tree(tree, dev)
    N = tree.num_nodes
    node = torch.zeros(rows.R, dtype=torch.int64, device=dev)
    frontier = torch.zeros(1, dtype=torch.int64, device=dev)
    levels = []
    for depth in range(P.max_depth):
        L, loc, live = _locate(frontier, node, N)
        cnt = torch.bincount(loc[live], minlength=L)
        Nl = _node_totals(rows, loc, live, L).sum(-1)
        active = Nl >= 2 * P.min_records
        if not bool(active.any()):
            break
        cand = candidates(forest_seed, tree_index, depth, L, P.m, P.m_prime,
                          dev) & active[:, None]
        levels.append(dict(rows=cnt.cpu().numpy(),
                           active=active.cpu().numpy(),
                           cand=cand.cpu().numpy()))
        split = tr["feature"][frontier] >= 0
        if not bool(split.any()):
            break
        node, frontier, _ = _route(rows, tr, node, frontier, loc, live,
                                   split)
    return levels


def grow(P: Problem, forest_seed: int, tree_index: int,
         dtype=torch.bfloat16) -> TreeArrays:
    """A tree grown by the reference's own search with every sum, count and
    gain in `dtype` and numeric values rounded to it (hist edges taken
    from the rounded values): the control the comparison must reject."""
    dev = P.y.device
    rows = _Rows(P, bag_counts(forest_seed, tree_index, P.n, dev), dtype)
    edges = hist_edges(P.num.to(dtype).float(), P.bins) \
        if P.mode == "hist" and P.m_num else None
    C = P.classes
    V = max(P.arities) if P.arities else 1
    feature, threshold, is_cat, masks, children, value, n_node = \
        [], [], [], [], [], [], []

    def new_node():
        feature.append(-1)
        threshold.append(0.0)
        is_cat.append(False)
        masks.append(np.zeros(V, bool))
        children.append([-1, -1])
        value.append(np.zeros(C, np.float32))
        n_node.append(0.0)
        return len(feature) - 1

    node = torch.zeros(rows.R, dtype=torch.int64, device=dev)
    frontier = [new_node()]
    for depth in range(P.max_depth + 1):
        fr = torch.as_tensor(frontier, device=dev)
        L, loc, live = _locate(fr, node, len(feature))
        tot = _node_totals(rows, loc, live, L)
        Nl = tot.sum(-1)
        dist = (tot / Nl.clamp(min=1e-12)[:, None]).float().cpu().numpy()
        Nh = Nl.float().cpu().numpy()
        for h, nd in enumerate(frontier):
            value[nd], n_node[nd] = dist[h], float(Nh[h])
        active = (Nl >= 2 * P.min_records) & (depth < P.max_depth)
        if not bool(active.any()):
            break
        cand = candidates(forest_seed, tree_index, depth, L, P.m, P.m_prime,
                          dev) & active[:, None]
        best, feat, thr, mk = _search(rows, edges, loc, live, L, cand,
                                      decide=True)
        will = (active & (best > SPLIT_EPS)).cpu().numpy()
        feat_h, thr_h = feat.cpu().numpy(), thr.cpu().numpy()
        mk_h = mk.cpu().numpy()
        nxt = []
        for h in np.flatnonzero(will):
            nd = frontier[h]
            feature[nd] = int(feat_h[h])
            if feat_h[h] < P.m_num:
                threshold[nd] = float(thr_h[h])
            else:
                is_cat[nd] = True
                masks[nd] = mk_h[h].copy()
            lc, rc = new_node(), new_node()
            children[nd] = [lc, rc]
            nxt += [lc, rc]
        if not nxt:
            break
        tr = dict(feature=torch.as_tensor(feature, device=dev),
                  threshold=torch.as_tensor(threshold, dtype=torch.float32,
                                            device=dev),
                  is_cat=torch.as_tensor(is_cat, device=dev),
                  cat_mask=torch.as_tensor(np.stack(masks), device=dev),
                  children=torch.as_tensor(children, device=dev))
        split = torch.as_tensor(will, device=dev)
        node, _, _ = _route(rows, tr, node, fr, loc, live, split)
        frontier = nxt
    return TreeArrays(
        feature=np.asarray(feature, np.int32),
        threshold=np.asarray(threshold, np.float32),
        is_cat=np.asarray(is_cat, bool), cat_mask=np.stack(masks),
        children=np.asarray(children, np.int32),
        value=np.stack(value).astype(np.float32),
        n_node=np.asarray(n_node, np.float32))
