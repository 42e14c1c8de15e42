"""GFA reader + generalized-bibubble tester for the downstream toolkit.

Python port of the reference's JS GFA class (pangene.js:93-387): S/L/W
parsing with vertex = sid*2|strand and a CSR arc index; get_bubble_id
implements the generalized-bibubble test (forward DFS from vs and reverse
DFS from ve^1 must visit identical vertex sets with no escape edges,
tex/pangene.tex:349-356); get_bubble_all BFS-collects candidate ends in the
same cycle-equivalence class.

Ordering quirks preserved for output parity with the k8 script: the
undirected-neighbor list is sorted *lexicographically by string* (JS default
Array.sort), and all sorts are stable.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional


def readlines(fn: str):
    import gzip
    opener = gzip.open if fn.endswith(".gz") else open
    with opener(fn, "rt") as fp:
        for line in fp:
            yield line.rstrip("\n")


class Arc:
    __slots__ = ("v", "w", "ov", "ow", "rank", "ori")

    def __init__(self, v, w, ov, ow, rank, ori):
        self.v, self.w, self.ov, self.ow, self.rank, self.ori = \
            v, w, ov, ow, rank, ori


class Seg:
    __slots__ = ("name", "len", "sname", "soff", "rank", "cec")

    def __init__(self, name):
        self.name = name
        self.len = -1
        self.sname = None
        self.soff = -1
        self.rank = -1
        self.cec = -1


class Walk:
    __slots__ = ("asm", "sample", "hap", "sname", "st", "en", "v", "lof")

    def __init__(self, asm, sample, hap, sname):
        self.asm, self.sample, self.hap, self.sname = asm, sample, hap, sname
        self.st = -1
        self.en = -1
        self.v: List[int] = []
        self.lof: List[int] = []


_RE_S_TAG = re.compile(r"^(LN:i|SN:Z|SO:i|SR:i):(\S+)")
_RE_CIGAR = re.compile(r"(\d+)([MIDSN])")
_RE_WALK = re.compile(r"([><])([^\s><]+)")


class GFA:
    def __init__(self):
        self.seg: List[Seg] = []
        self.arc: List[Arc] = []
        self.segname: Dict[str, int] = {}
        self.idx: List[tuple] = []   # (offset, count) per vertex
        self.walk: List[Walk] = []
        self.err = 0

    # -- construction -----------------------------------------------------

    def _seg_add(self, name: str) -> int:
        sid = self.segname.get(name)
        if sid is None:
            sid = len(self.seg)
            self.segname[name] = sid
            self.seg.append(Seg(name))
        return sid

    def _parse_S(self, t: List[str]) -> None:
        if len(t) < 3:
            return
        s = self.seg[self._seg_add(t[1])]
        if t[2] != "*":
            s.len = len(t[2])
        for f in t[3:]:
            m = _RE_S_TAG.match(f)
            if not m:
                continue
            tag, val = m.group(1), m.group(2)
            if tag == "LN:i":
                s.len = int(val)
            elif tag == "SN:Z":
                s.sname = val
            elif tag == "SO:i":
                s.soff = int(val)
            elif tag == "SR:i":
                s.rank = int(val)

    def _parse_L(self, t: List[str]) -> None:
        if len(t) < 5:
            return
        if t[2] not in "+-" or t[4] not in "+-" or not t[2] or not t[4]:
            return
        sid1 = self._seg_add(t[1])
        sid2 = self._seg_add(t[3])
        v = sid1 * 2 | (0 if t[2] == "+" else 1)
        w = sid2 * 2 | (0 if t[4] == "+" else 1)
        ov = ow = 0
        rank = -1
        if len(t) >= 6:
            for m in _RE_CIGAR.finditer(t[5]):
                n, op = int(m.group(1)), m.group(2)
                if op in "MDN":
                    ov += n
                if op in "MIS":
                    ow += n
            for f in t[6:]:
                m = re.match(r"^(SR:i):(\S+)", f)
                if m:
                    rank = int(m.group(2))
        self.arc.append(Arc(v, w, ov, ow, rank, True))

    def _parse_W(self, t: List[str]) -> None:
        if len(t) < 7:
            return
        try:
            hap = int(t[2])
        except ValueError:
            hap = 0
        w = Walk(t[1] + "#" + t[2], t[1], hap, t[3])
        if t[4] != "*":
            w.st = int(t[4])
        if t[5] != "*":
            w.st = int(t[5])  # [sic] reference never sets .en (pangene.js:175)
        for m in _RE_WALK.finditer(t[6]):
            sid = self.segname.get(m.group(2))
            if sid is not None:
                w.v.append(sid * 2 | (0 if m.group(1) == ">" else 1))
        for f in t[7:]:
            if f.startswith("lf:B:i"):
                w.lof = [int(x) for x in f[7:].split(",")]
        self.walk.append(w)

    def _index(self) -> None:
        n_vtx = len(self.seg) * 2
        self.idx = [(0, 0)] * n_vtx
        self.arc.sort(key=lambda a: a.v)  # stable
        st = 0
        n = len(self.arc)
        for i in range(1, n + 1):
            if i == n or self.arc[i].v != self.arc[st].v:
                self.idx[self.arc[st].v] = (st, i - st)
                st = i
        # reorder so a rank-0 arc comes first (pangene.js:115-129)
        for v in range(n_vtx):
            ov, nv = self.idx[v]
            i0 = -1
            n0 = 0
            for i in range(nv):
                if self.arc[ov + i].rank == 0:
                    n0 += 1
                    i0 = i
            if n0 > 1:
                self.err |= 2
            if i0 > 0:
                self.arc[ov], self.arc[ov + i0] = \
                    self.arc[ov + i0], self.arc[ov]

    def symmetrize(self) -> None:
        """Add missing dual links w^1 -> v^1 (extension; the reference has a
        TODO for this, pangene.js:167) and reindex. Needed for GFAs that list
        only one direction per edge (e.g. the test/bubble fixtures)."""
        seen = {(a.v, a.w) for a in self.arc}
        for a in list(self.arc):
            key = (a.w ^ 1, a.v ^ 1)
            if key not in seen:
                seen.add(key)
                self.arc.append(Arc(key[0], key[1], a.ow, a.ov, a.rank, True))
        self._index()

    def from_file(self, fn: str) -> "GFA":
        for line in readlines(fn):
            self._parse_line(line)
        self._index()
        return self

    def from_string(self, s: str) -> "GFA":
        for line in s.split("\n"):
            self._parse_line(line)
        self._index()
        return self

    def _parse_line(self, line: str) -> None:
        if line.startswith("S"):
            self._parse_S(line.split("\t"))
        elif line.startswith("L"):
            self._parse_L(line.split("\t"))
        elif line.startswith("W"):
            self._parse_W(line.split("\t"))

    # -- bubbles -----------------------------------------------------------

    def _traverse_bubble(self, vs: int, ve: int, flag: List[int], f: int,
                         max_n: int) -> List[int]:
        """Bounded DFS from vs toward ve (pangene.js:236-256)."""
        stack = [vs]
        out: List[int] = []
        flag[vs] = f
        while stack:
            v = stack.pop()
            off, n = self.idx[v]
            for i in range(n):
                w = self.arc[off + i].w
                if w == (vs ^ 1):
                    continue  # don't pass the start on either strand
                if w == (ve ^ 1):
                    return []  # reached reverse complement of the end
                if flag[w] != f:
                    flag[w] = f
                    if w == ve:
                        continue  # flag the end but don't expand it
                    if flag[w ^ 1] != f:
                        out.append(w >> 1)
                    stack.append(w)
            if len(out) > max_n:
                break
        return [] if len(out) > max_n else out

    def get_bubble_id(self, vs: int, ve: int, flag: List[int], f: int,
                      max_n: int) -> List[int]:
        """Generalized-bibubble test (pangene.js:257-279): the forward and
        reverse traversals must see the same segment set with no escapes."""
        f_for = f
        f_rev = f + len(self.seg) * 2
        list_for = self._traverse_bubble(vs, ve, flag, f_for, max_n)
        list_rev = self._traverse_bubble(ve ^ 1, vs ^ 1, flag, f_rev, max_n)
        if len(list_for) != len(list_rev):
            return []
        n_in = 0
        for s in list_for:
            if flag[s << 1] == f_rev or flag[s << 1 | 1] == f_rev:
                n_in += 1
        if n_in != len(list_for):
            return []
        for s in list_for:
            for rev in (0, 1):
                v = s << 1 | rev
                off, n = self.idx[v]
                for j in range(n):
                    w = self.arc[off + j].w
                    if flag[w] != f_for and flag[w] != f_rev:
                        return []  # escape edge
        return list_for

    def get_bubble(self, vs, ve, flag, f, max_n):
        return [self.seg[s].name
                for s in self.get_bubble_id(vs, ve, flag, f, max_n)]

    def _get_undirected_neighbor(self, v: int) -> List[int]:
        a: List[int] = []
        off_v, n_v = self.idx[v]
        for i in range(n_v):
            w = self.arc[off_v + i].w
            a.append(w)
            off_w, n_w = self.idx[w ^ 1]
            for j in range(n_w):
                u = self.arc[off_w + j].w
                if u != (v ^ 1):
                    a.append(u)
        if not a:
            return []
        a.sort(key=str)  # [sic] JS default sort is lexicographic
        out = [a[0]]
        for x in a[1:]:
            if x != out[-1]:
                out.append(x)
        return out

    def get_bubble_all(self, max_ext: int) -> List[dict]:
        """All bibubbles between same-cycle-equivalence-class ends
        (pangene.js:306-386). Requires seg.cec set by NetGraph.mark_cec."""
        n_vtx = len(self.seg) * 2
        f1 = 0
        f2 = 0
        flag1 = [-1] * n_vtx
        flag2 = [-1] * n_vtx
        bb: List[dict] = []
        for vs in range(n_vtx):
            cec = self.seg[vs >> 1].cec
            if cec < 0 or self.idx[vs][1] == 0:
                continue
            if self.idx[vs][1] == 1:
                w = self.arc[self.idx[vs][0]].w ^ 1
                if self.idx[w][1] < 2:
                    continue
            # BFS from vs collecting candidate ends in the same cec class
            queue = [vs]
            ve: List[int] = []
            ext = 0
            flag1[vs] = f1
            qi = 0
            while qi < len(queue):
                v = queue[qi]
                qi += 1
                for w in self._get_undirected_neighbor(v):
                    if flag1[w] != f1:
                        if flag1[w ^ 1] != f1:
                            ext += 1
                        if w == (vs ^ 1):
                            continue
                        flag1[w] = f1
                        if self.seg[w >> 1].cec == cec:
                            ve.append(w)
                            continue
                        queue.append(w)
                if ext > max_ext:
                    break
            for e in ve:
                r = self.get_bubble_id(vs, e, flag2, f2, max_ext)
                if r and vs < e:
                    bb.append({"cec": cec, "par": -1, "vs": vs, "ve": e,
                               "flt": False, "seg": r,
                               "list": [self.seg[s].name for s in r]})
                f2 += 1
            f1 += 1
        # nesting parents: larger bubbles first (stable), a bubble is nested
        # iff all its segments map to the same enclosing bubble
        aux = sorted(range(len(bb)), key=lambda i: -len(bb[i]["seg"]))
        flag3 = [-1] * len(self.seg)
        for bid in aux:
            b = bb[bid]
            par = -2
            nested = True
            for s in b["seg"]:
                if par == -2:
                    par = flag3[s]
                elif par != flag3[s]:
                    nested = False
                flag3[s] = bid
            b["par"] = par if nested else -2
        return bb
