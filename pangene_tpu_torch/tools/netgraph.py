"""Net graph + cycle equivalence + bubble calling.

Python port of the reference's NetGraph (pangene.js:450-931): the biedged
pangene graph is contracted into a net graph (link-edge connected components
become nodes, each gene contributes two directed arcs), an iterative DFS
types tree/back edges, and Johnson et al. (1994) cycle equivalence runs via
intrusive bracket lists with capping back-edges (pangene.js:640-735 — note
the hi2<t capping condition differs from the original paper). Bubbles are
projected onto W-line intervals and distinct allele walks counted per bubble
(walk_ht / count_allele, pangene.js:836-905).

Everything here is small host-side graph work (~20k nodes for a human
pangenome); determinism and parity with the k8 script drive the design.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional

from .gfa import GFA


def tprint(*args) -> None:
    """k8 print(): TAB-joined arguments."""
    sys.stdout.write("\t".join(str(a) for a in args) + "\n")


class _Node:
    """Intrusive doubly-linked bracket-list node (BackEdgeNode,
    pangene.js:440-448)."""
    __slots__ = ("a", "recent_size", "recent_cec", "prev", "next")

    def __init__(self, a: int):
        self.a = a
        self.recent_size = -1
        self.recent_cec = -1
        self.prev: Optional["_Node"] = None
        self.next: Optional["_Node"] = None


class _LinkedList:
    __slots__ = ("size", "head", "tail")

    def __init__(self):
        self.size = 0
        self.head: Optional[_Node] = None
        self.tail: Optional[_Node] = None

    def push(self, node: _Node) -> None:
        if self.head is None and self.tail is None:
            self.head = self.tail = node
        else:
            self.tail.next = node
            node.prev = self.tail
            self.tail = node
        self.size += 1

    def push_list(self, other: Optional["_LinkedList"]) -> None:
        if other is None or (other.head is None and other.tail is None):
            return
        if self.head is None and self.tail is None:
            self.head = other.head
            self.tail = other.tail
        else:
            self.tail.next = other.head
            other.head.prev = self.tail
            self.tail = other.tail
        self.size += other.size

    def delete(self, node: _Node) -> None:
        if self.head is node and self.tail is node:
            self.head = self.tail = None
        elif self.tail is node:
            self.tail = node.prev
            self.tail.next = None
        elif self.head is node:
            self.head = node.next
            self.head.prev = None
        else:
            node.prev.next = node.next
            node.next.prev = node.prev
        self.size -= 1


class NetArc:
    __slots__ = ("v", "w", "seg", "ori", "pair", "cec", "dfs_type")

    def __init__(self, v, w, seg, ori):
        self.v, self.w, self.seg, self.ori = v, w, seg, ori
        self.pair = -1
        self.cec = -1
        self.dfs_type = 0  # 0 none, 1 tree, 2 back, 3 blocked


class NetGraph:
    def __init__(self, g: GFA, add_super: bool = False,
                 ref: Optional[str] = None):
        self.n_node = 0
        self.end_cat: List[int] = []
        self.arc: List[NetArc] = []
        self.idx: List[tuple] = []
        self.dfs_dis: List[int] = []
        self.dfs_fin: List[int] = []
        self.dfs_par: List[int] = []
        self.gfa = g
        self.add_super = add_super
        self.ref = ref if isinstance(ref, str) else None
        self._convert_gfa()

    # -- biedged -> net graph (pangene.js:464-564) --------------------------

    def _convert_gfa(self) -> None:
        g = self.gfa
        n_vtx = len(g.seg) * 2
        # link edges (v^1 -> w), sorted by source, then CCs = net nodes
        a = []
        for v in range(n_vtx):
            off, n = g.idx[v]
            for i in range(n):
                a.append((v ^ 1, g.arc[off + i].w))
        # undirected connected components, labeled in first-vertex order.
        # (the reference walks the directed link list and would crash on a
        # GFA lacking dual L lines; on symmetric pangene output both give
        # identical labels)
        adj: List[List[int]] = [[] for _ in range(n_vtx)]
        for src, dst in a:
            adj[src].append(dst)
            adj[dst].append(src)
        x = 0
        self.end_cat = [-1] * n_vtx
        for v in range(n_vtx):
            if self.end_cat[v] >= 0:
                continue
            stack = [v]
            self.end_cat[v] = x
            while stack:
                w = stack.pop()
                for u in adj[w]:
                    if self.end_cat[u] < 0:
                        self.end_cat[u] = x
                        stack.append(u)
            x += 1
        self.n_node = x
        # two directed net arcs per gene
        self.arc = []
        for i in range(len(g.seg)):
            self.arc.append(NetArc(self.end_cat[i * 2],
                                   self.end_cat[i * 2 | 1], i, 1))
            self.arc.append(NetArc(self.end_cat[i * 2 | 1],
                                   self.end_cat[i * 2], i, -1))
        if self.add_super:
            tip = [v ^ 1 for v in range(n_vtx) if g.idx[v][1] == 0]
            if self.ref and g.walk:
                f = [0] * n_vtx
                for t in tip:
                    f[t] = 1
                for w in g.walk:
                    if w.asm != self.ref or len(w.v) < 2:
                        continue
                    t1, t2 = w.v[0], w.v[-1] ^ 1
                    if f[t1] == 0:
                        f[t1] = 2
                    if f[t2] == 0:
                        f[t2] = 2
                for v in range(n_vtx):
                    if f[v] == 2:
                        tip.append(v)
            if tip:
                super_node = self.n_node
                self.n_node += 1
                seg_id = len(g.seg)
                for v in tip:
                    self.arc.append(NetArc(super_node, self.end_cat[v],
                                           seg_id, 1))
                    self.arc.append(NetArc(self.end_cat[v], super_node,
                                           seg_id, -1))
                    seg_id += 1
        # index + complement pairing
        self.idx = [(0, 0)] * self.n_node
        self.arc.sort(key=lambda ar: ar.v)  # stable
        i0 = 0
        for i in range(1, len(self.arc) + 1):
            if i == len(self.arc) or self.arc[i0].v != self.arc[i].v:
                self.idx[self.arc[i0].v] = (i0, i - i0)
                i0 = i
        n_seg_all = max((ar.seg for ar in self.arc), default=-1) + 1
        vtx2arc = [-1] * (n_seg_all * 2)
        for ai, ar in enumerate(self.arc):
            vtx2arc[ar.seg * 2 + (0 if ar.ori > 0 else 1)] = ai
        for ar in self.arc:
            ar.pair = vtx2arc[ar.seg * 2 + (1 if ar.ori > 0 else 0)]

    # -- DFS with tree/back typing (pangene.js:565-606) ---------------------

    def _dfs_traverse1(self, v: int, t: dict, state: List[int]) -> None:
        if state[v] != 0:
            return
        self.dfs_dis[v] = t["dis"]
        t["dis"] += 1
        state[v] = 2  # in stack
        stack = [(v, 0)]
        while stack:
            w, i = stack.pop()
            off, n = self.idx[w]
            if i < n:
                a = self.arc[off + i]
                stack.append((w, i + 1))
                if a.dfs_type == 3:
                    continue
                u = a.w
                if state[u] == 0:
                    state[u] = 2
                    self.dfs_dis[u] = t["dis"]
                    t["dis"] += 1
                    self.dfs_par[u] = w
                    stack.append((u, 0))
                    a.dfs_type = 1                    # tree edge
                    self.arc[a.pair].dfs_type = 3     # block the complement
                elif state[u] == 2:
                    a.dfs_type = 2                    # back edge
                    self.arc[a.pair].dfs_type = 3
            else:
                state[w] = 1
                self.dfs_fin[w] = t["fin"]
                t["fin"] += 1

    def dfs_traverse(self) -> None:
        self.dfs_dis = [-1] * self.n_node
        self.dfs_fin = [-1] * self.n_node
        self.dfs_par = [-1] * self.n_node
        t = {"dis": 0, "fin": 0}
        state = [0] * self.n_node
        if self.n_node:
            self._dfs_traverse1(self.n_node - 1, t, state)  # super node first
        for v in range(self.n_node):
            if state[v] == 0:
                self._dfs_traverse1(v, t, state)
        if t["dis"] != self.n_node or t["fin"] != self.n_node:
            raise AssertionError("DFS bug")

    # -- Johnson et al. cycle equivalence (pangene.js:640-735) --------------

    def mark_cec(self) -> int:
        self.dfs_traverse()
        v_dis = [0] * self.n_node
        for v in range(self.n_node):
            v_dis[self.dfs_dis[v]] = v
        INF = self.n_node
        vs = [{"hi": INF, "blist": None, "be_end": [], "be_end_cap": []}
              for _ in range(self.n_node)]
        cec = 1  # class 0 reserved for tree edges not in any cycle
        for t in range(self.n_node - 1, -1, -1):
            v = v_dis[t]
            off, n = self.idx[v]
            # hi0: earliest discovery among back edges from v
            hi0 = INF
            for i in range(n):
                a = self.arc[off + i]
                if a.dfs_type != 2 or a.w == v:
                    continue
                if self.dfs_dis[a.w] < hi0:
                    hi0 = self.dfs_dis[a.w]
            # hi1/hi2: earliest and second earliest among tree children
            hi1 = hi2 = INF
            blist = _LinkedList()
            for i in range(n):
                a = self.arc[off + i]
                if a.dfs_type != 1:
                    continue
                child_hi = vs[a.w]["hi"]
                if hi1 > child_hi:
                    hi2, hi1 = hi1, child_hi
                elif hi2 > child_hi:
                    hi2 = child_hi
                blist.push_list(vs[a.w]["blist"])
            vs[v]["hi"] = hi0 if hi0 < hi1 else hi1
            for b in vs[v]["be_end_cap"]:
                blist.delete(b)
            for b in vs[v]["be_end"]:
                blist.delete(b)
                if self.arc[b.a].cec < 0:
                    self.arc[b.a].cec = cec
                    cec += 1
            for i in range(n):  # back edges starting at v
                a = self.arc[off + i]
                if a.dfs_type != 2 or a.w == v:
                    continue
                e = _Node(off + i)
                blist.push(e)
                vs[a.w]["be_end"].append(e)
            if hi2 < hi0 and hi2 < t:  # capping back edge ([sic] differs
                w = v_dis[hi2]         # from Johnson et al, pangene.js:696)
                d = _Node(-1)
                blist.push(d)
                vs[w]["be_end_cap"].append(d)
            vs[v]["blist"] = blist
            # category for the tree edge (parent(v), v)
            if self.dfs_par[v] >= 0:
                u = self.dfs_par[v]
                offu, nu = self.idx[u]
                e = -1
                for i in range(nu):
                    if self.arc[offu + i].w == v \
                            and self.arc[offu + i].dfs_type == 1:
                        e = offu + i
                if e < 0:
                    raise AssertionError("tree edge %d->%d missing" % (u, v))
                if blist.size > 0:
                    b = blist.tail
                    if b.recent_size != blist.size:
                        b.recent_size = blist.size
                        b.recent_cec = cec
                        cec += 1
                    self.arc[e].cec = b.recent_cec
                    if b.recent_size == 1 and b.a >= 0:
                        self.arc[b.a].cec = self.arc[e].cec
                else:
                    self.arc[e].cec = 0
        # project classes back onto GFA segments
        for a in self.arc:
            if a.seg < len(self.gfa.seg) and a.dfs_type in (1, 2):
                self.gfa.seg[a.seg].cec = a.cec
        return cec

    # -- program structure tree (pangene.js:607-631, 736-772) ---------------

    def _dfs_pst1(self, v, visited, cec_entry, sese) -> None:
        if visited[v]:
            return
        visited[v] = 1
        stack = [(v, 0, -1)]
        while stack:
            w, i, b = stack.pop()
            off, n = self.idx[w]
            if i == n:
                continue
            stack.append((w, i + 1, b))
            a = self.arc[off + i]
            if a.dfs_type == 3:
                continue
            u = a.w
            b2 = b
            if a.cec >= 0:
                par = b
                if cec_entry[a.cec] != -1:
                    sese[cec_entry[a.cec]]["en"] = off + i
                    par = sese[cec_entry[a.cec]]["par"]
                sese.append({"cec": a.cec, "st": off + i, "en": -1,
                             "par": par, "unflt": -1, "i": -1})
                b2 = cec_entry[a.cec] = len(sese) - 1
            if visited[u]:
                continue
            visited[u] = 1
            stack.append((u, 0, b2))

    def pst(self) -> List[dict]:
        cec = self.mark_cec()
        v_dis = [0] * self.n_node
        for v in range(self.n_node):
            v_dis[self.dfs_dis[v]] = v
        state = [0] * self.n_node
        sese: List[dict] = []
        cec_entry = [-1] * cec
        for t in range(self.n_node):
            v = v_dis[t]
            if state[v] == 0:
                self._dfs_pst1(v, state, cec_entry, sese)
        sese_flt: List[dict] = []
        ngseg = len(self.gfa.seg)
        for i, b in enumerate(sese):
            flt = False
            if b["en"] < 0:
                flt = True  # open bubble
            elif self.arc[b["st"]].seg >= ngseg \
                    or self.arc[b["en"]].seg >= ngseg:
                flt = True  # involves the super node
            elif self.arc[b["st"]].w == self.arc[b["en"]].v \
                    and self.idx[self.arc[b["en"]].v][1] == 2:
                flt = True  # point bubble
            if flt:
                b["unflt"] = sese[b["par"]]["unflt"] if b["par"] >= 0 else -1
            else:
                b["unflt"] = i
                if b["par"] >= 0:
                    b["par"] = sese[b["par"]]["unflt"]
                b["i"] = len(sese_flt)
                par = -1 if b["par"] < 0 else sese[b["par"]]["i"]
                sese_flt.append({"cec": b["cec"], "st": b["st"],
                                 "en": b["en"], "par": par,
                                 "vs": -1, "ve": -1, "flt": False})
        self._cal_vs_ve(sese_flt)
        return sese_flt

    def _cal_vs_ve(self, sese: List[dict]) -> None:
        for b in sese:
            if b["en"] < 0:
                continue
            b["vs"] = self.arc[b["st"]].seg * 2 \
                + (0 if self.arc[b["st"]].ori > 0 else 1)
            b["ve"] = self.arc[b["en"]].seg * 2 \
                + (0 if self.arc[b["en"]].ori > 0 else 1)

    # -- top-level bubble calling (pangene.js:773-795) -----------------------

    def get_bb(self, max_ext: int, use_pst: bool,
               ignore_walk: bool) -> List[dict]:
        g = self.gfa
        if use_pst:
            bb = self.pst()
            flag = [-1] * (len(g.seg) * 2)
            for i, b in enumerate(bb):
                names = g.get_bubble(b["vs"], b["ve"], flag, i, max_ext)
                if not names:
                    b["flt"] = True
                else:
                    b["list"] = names
        else:
            self.mark_cec()
            bb = g.get_bubble_all(max_ext)
        if not ignore_walk and g.walk:
            ht = self.walk_ht(bb)
            self.count_allele(bb, ht, max_ext)
        return bb

    # -- walk projection + allele counting (pangene.js:836-905) -------------

    def walk_ht(self, sese: List[dict]) -> Dict[int, list]:
        g = self.gfa
        n_vtx = len(g.seg) * 2
        st = [[] for _ in range(n_vtx)]
        en = [{"walk": -1, "a": []} for _ in range(n_vtx)]
        ht: Dict[int, list] = {}
        for i, b in enumerate(sese):
            if b.get("en", 0) is not None and b.get("en", 0) < 0:
                continue
            ht[i] = []
            st[b["vs"]].append({"en": b["ve"], "bid": i, "ori": 1})
            st[b["ve"] ^ 1].append({"en": b["vs"] ^ 1, "bid": i, "ori": -1})
        for j, w in enumerate(g.walk):
            for i, v in enumerate(w.v):
                for rec in st[v]:
                    e = en[rec["en"]]
                    if e["walk"] != j:
                        e["walk"] = j
                        e["a"] = []
                    e["a"].append({"st_off": i, "bid": rec["bid"],
                                   "ori": rec["ori"]})
                if en[v]["walk"] != j:
                    continue
                for x in en[v]["a"]:
                    ht[x["bid"]].append({"walk": j, "st_off": x["st_off"],
                                         "en_off": i, "bid": x["bid"],
                                         "ori": x["ori"]})
        return ht

    def count_allele(self, sese: List[dict], ht: Dict[int, list],
                     max_ext: int) -> None:
        g = self.gfa
        for i, b in enumerate(sese):
            gene_seen = set()
            gene_list: List[str] = []
            for x in ht.get(i, []):
                w = g.walk[x["walk"]]
                for k in range(x["st_off"] + 1, x["en_off"]):
                    v = w.v[k]
                    if (v >> 1) not in gene_seen:
                        gene_seen.add(v >> 1)
                        gene_list.append(g.seg[v >> 1].name)
            b["n_gene"] = len(gene_list)
            b["gene"] = []
            b["al"] = []
            if len(gene_list) > max_ext:
                continue
            b["gene"] = gene_list
            al: Dict[str, dict] = {}
            for x in ht.get(i, []):
                w = g.walk[x["walk"]]
                if x["ori"] > 0:
                    a = [w.v[k] for k in range(x["st_off"], x["en_off"] + 1)]
                else:
                    a = [w.v[k] ^ 1
                         for k in range(x["en_off"], x["st_off"] - 1, -1)]
                s = ",".join(map(str, a))
                if s not in al:
                    al[s] = {"a": list(a), "asm": []}
                al[s]["asm"].append(w.asm)
            for rec in al.values():
                b["al"].append({"n": len(rec["asm"]), "a": rec["a"],
                                "asm": rec["asm"]})
            b["al"].sort(key=lambda r: -r["n"])  # stable

    # -- printers (pangene.js:803-930) ---------------------------------------

    def print_bandage_csv(self) -> None:
        g = self.gfa
        print("segment,label")
        for a in self.arc:
            if a.seg < len(g.seg) and a.dfs_type in (1, 2) and a.cec >= 0:
                print("%s,%d" % (g.seg[a.seg].name, a.cec))

    def print_dfs(self) -> None:
        g = self.gfa
        if not self.dfs_dis:
            self.dfs_traverse()
        v_dis = [0] * self.n_node
        for v in range(self.n_node):
            v_dis[self.dfs_dis[v]] = v
        for v in v_dis:
            off, n = self.idx[v]
            for i in range(n):
                a = self.arc[off + i]
                if a.dfs_type in (1, 2):
                    tprint("DF", ["tree", "back"][a.dfs_type - 1],
                           "%d,%d" % (v, a.w),
                           ("><"[0 if a.ori > 0 else 1] + g.seg[a.seg].name
                            if a.seg < len(g.seg) else "*"))

    def print_cycle_equiv(self) -> None:
        g = self.gfa
        for a in self.arc:
            if a.dfs_type in (1, 2):
                tprint("EC", a.cec, ["tree", "back"][a.dfs_type - 1],
                       "%d,%d" % (a.v, a.w),
                       ("><"[0 if a.ori > 0 else 1] + g.seg[a.seg].name
                        if a.seg < len(g.seg) else "*"))

    def print_bb(self, bb: List[dict]) -> None:
        g = self.gfa
        for i, b in enumerate(bb):
            vs, ve = b["vs"], b["ve"]
            has_al = "gene" in b and "al" in b
            if b["flt"]:
                tprint("FB", i, b["par"], b["cec"],
                       "><"[vs & 1] + g.seg[vs >> 1].name,
                       "><"[ve & 1] + g.seg[ve >> 1].name)
            elif has_al:
                gene = b["gene"]
                gene_list = b["n_gene"] if len(gene) == 0 \
                    else "%d\t%s" % (len(gene), ",".join(gene))
                if len(b["al"]) < 2:
                    continue
                tprint("BB", i, b["par"], b["cec"],
                       "><"[vs & 1] + g.seg[vs >> 1].name,
                       "><"[ve & 1] + g.seg[ve >> 1].name,
                       len(b["al"]), gene_list)
                for rec in b["al"]:
                    walk_str = "".join("><"[v & 1] + g.seg[v >> 1].name
                                       for v in rec["a"])
                    tprint("AL", rec["n"], walk_str, ",".join(rec["asm"]))
            else:
                tprint("BB", i, b["par"], b["cec"],
                       "><"[vs & 1] + g.seg[vs >> 1].name,
                       "><"[ve & 1] + g.seg[ve >> 1].name,
                       -1, len(b["list"]), ",".join(b["list"]))
            if has_al:
                tprint("//")
