"""Downstream toolkit CLI: the pangene.js subcommand suite in Python.

    python -m pangene_tpu_torch.tools.cli <command> [arguments]

Subcommands (reference pangene.js:1333-1363): call, call2html, calldiff,
bed2paf, gfa2matrix, getaa, outgroup, flt-mmseqs, version. Output formats
match the k8 script byte-for-byte (TAB-joined print semantics). Pure host
code: it imports no torch and takes no device.
"""
from __future__ import annotations

import re
import sys
from typing import List

from ..options import PG_REF_VERSION, PG_VERSION
from .gfa import GFA, readlines
from .netgraph import NetGraph, tprint


def _getopt(args: List[str], optstr: str):
    """k8 getopt (reference pangene.js:15-77, longopts=[]): bundled short
    flags (`-bd`), inline or following option arguments, `--` terminates
    parsing (and stays in the remainder, as in k8), consumed argv items are
    deleted so `rest` is exactly the surviving argv; unknown options
    (including any `--long`) yield '?' which callers ignore."""
    opts = []
    argv = list(args)
    pos = 0
    cur = 0
    while cur < len(argv):
        while cur < len(argv):  # skip non-option arguments
            if argv[cur].startswith("-") and len(argv[cur]) > 1:
                if argv[cur] == "--":
                    cur = len(argv)
                break
            cur += 1
        if cur >= len(argv):
            break
        a = argv[cur]
        arg = ""
        if a.startswith("--"):  # long option; no longopts defined -> '?'
            pos = -1
            opt = "?"
        else:
            if pos == 0:
                pos = 1
            opt = a[pos]
            pos += 1
            k = optstr.find(opt)
            if k < 0:
                opt = "?"
            elif k + 1 < len(optstr) and optstr[k + 1] == ":":
                if pos >= len(a):
                    if cur + 1 < len(argv):
                        arg = argv[cur + 1]
                        del argv[cur + 1]
                else:
                    arg = a[pos:]
                pos = -1
        if pos < 0 or pos >= len(a):
            del argv[cur]
            pos = 0
        opts.append(("-" + opt if opt != "?" else "?", arg))
    return opts, argv


def cmd_call(args: List[str]) -> None:
    opt = {"print_bb": True, "print_bandage": False, "print_cec": False,
           "print_dfs": False, "max_ext": 100, "ignore_walk": False,
           "use_pst": False, "add_super": False, "ref": None, "sym": False}
    if "--sym" in args:
        args = [a for a in args if a != "--sym"]
        opt["sym"] = True
    opts, rest = _getopt(args, "bedpm:wr:s")
    for o, a in opts:
        if o == "-b":
            opt["print_bandage"], opt["print_bb"] = True, False
        elif o == "-e":
            opt["print_cec"], opt["print_bb"] = True, False
        elif o == "-d":
            opt["print_dfs"], opt["print_bb"] = True, False
        elif o == "-m":
            opt["max_ext"] = int(a)
        elif o == "-w":
            opt["ignore_walk"] = True
        elif o == "-r":
            opt["ref"] = a
        elif o == "-p":
            opt["use_pst"] = True
        elif o == "-s":
            opt["add_super"] = True
    if not rest:
        print("Usage: pangene-tools call [options] <in.gfa>")
        print("Options:")
        print("  General:")
        print("    -m INT   don't output gene lists longer than INT [%d]"
              % opt["max_ext"])
        print("    -w       ignore walks")
        print("    -b       output equivalent classes for Bandage visualization")
        print("  Use PST:")
        print("    -p       use program structure tree (PST) to find bubbles")
        print("    -s       add a super node (preferred and only effectively with -p)")
        print("    -r INT   reference assembly for additional edges to the super node []")
        print("    --sym    add missing dual links before calling (extension)")
        print("  Debugging:")
        print("    -d       output DFS traversal")
        print("    -e       output cycle equivalent class")
        return
    g = GFA().from_file(rest[0])
    if opt["sym"]:
        g.symmetrize()
    net = NetGraph(g, opt["add_super"], opt["ref"])
    bb = net.get_bb(opt["max_ext"], opt["use_pst"], opt["ignore_walk"])
    if opt["print_dfs"]:
        net.print_dfs()
    if opt["print_bandage"]:
        net.print_bandage_csv()
    if opt["print_cec"]:
        net.print_cycle_equiv()
    if opt["print_bb"]:
        tprint("CC", "FB  bbID  parID  side1  side2")
        tprint("CC", "BB  bbID  parID  side1  side2  #alleles  #genes  "
               "geneList  supportingAsm")
        tprint("CC", "AL  #hap  walk")
        tprint("CC")
        net.print_bb(bb)


def cmd_call2html(args: List[str]) -> None:
    endpoint, graph = "/view", None
    opts, rest = _getopt(args, "e:g:")
    for o, a in opts:
        if o == "-e":
            endpoint = a
        elif o == "-g":
            graph = a
    if not rest:
        print("Usage: pangene-tools call2html [options] <pangene-call.out>")
        print("Options:")
        print("  -e STR     endpoint [%s]" % endpoint)
        print("  -g STR     graph name []")
        return
    print("<head>")
    print("<title>List of variants</title>")
    print('<style type="text/css">')
    print('  table { font-family: "helvetica neue", helvetica, arial, '
          'sans-serif; font-size: 0.8em; text-align: left; }')
    print("  th, td { padding: 2px; }")
    print("  a { text-decoration: none; color: blue; }")
    print("</style>")
    print("</head>")
    print("<body>")
    print('<table border="1" style="border-collapse: collapse; '
          'max-width: 1024px; width: 100%;">')
    print("<tr><th>VarID<th>Parent<th>#alleles<th>End genes<th>Genes</tr>")
    for line in readlines(rest[0]):
        t = line.split("\t")
        if t[0] != "BB" or len(t) < 9:
            continue
        st = ("&gt;" if t[4][0] == ">" else "&lt;") + t[4][1:]
        en = ("&gt;" if t[5][0] == ">" else "&lt;") + t[5][1:]
        genes = ",".join([t[4][1:], t[8], t[5][1:]])
        link = endpoint + "?"
        if graph is not None:
            link += "graph=%s&" % graph
        link += "gene=%s&step=0&ori=%s" % (genes, t[4][1:])
        gene_space = t[8].replace(",", ", ")
        out = ('<tr><td style="text-align: right;">%s'
               '<td style="text-align: right;">%s'
               '<td style="text-align: right;">%s' % (t[1], t[2], t[6]))
        out += ('<td style="white-space: nowrap;">'
                '<a href="%s" target="_blank">%s &mdash; %s</a><td>%s</tr>'
                % (link, st, en, gene_space))
        print(out)
    print("</table>")
    print("</body>")


def cmd_calldiff(args: List[str]) -> None:
    _, rest = _getopt(args, "")
    if len(rest) < 2:
        print("Usage: pangene-tools calldiff <call1.out> <call2.out>")
        return
    h = {}
    for line in readlines(rest[0]):
        t = line.split("\t")
        if t[0] != "BB":
            continue
        g1, g2 = t[4][1:], t[5][1:]
        key = "%s\t%s" % ((g1, g2) if g1 < g2 else (g2, g1))
        h[key] = [False, "\t".join(t[1:])]
    for line in readlines(rest[1]):
        t = line.split("\t")
        if t[0] != "BB":
            continue
        g1, g2 = t[4][1:], t[5][1:]
        key = "%s\t%s" % ((g1, g2) if g1 < g2 else (g2, g1))
        if key in h:
            h[key][0] = True
        else:
            tprint("B2", "\t".join(t[1:]))
    for key, (seen, rec) in h.items():
        if not seen:
            tprint("B1", rec)


def cmd_getaa(args: List[str]) -> None:
    species, excl_decay, keep_thru, canon_only = None, False, False, False
    opts, rest = _getopt(args, "s:erc")
    for o, a in opts:
        if o == "-s":
            species = a
        elif o == "-e":
            excl_decay = True
        elif o == "-r":
            keep_thru = True
        elif o == "-c":
            canon_only = True
    if len(rest) < 2:
        print("Usage: pangene-tools getaa [options] <anno.gtf> <proteins.faa>")
        print("Options:")
        print("  -s STR     species name []")
        print("  -e         exclude transcripts that are not protein_coding")
        print("  -r         keep readthrough transcripts")
        print("  -c         canonical only (for GenCode)")
        return
    attr_re = re.compile(r'([^\s"]+) "([^\s"]+)"')
    h = {}
    for line in readlines(rest[0]):
        if line.startswith("#"):
            continue
        t = line.split("\t")
        if len(t) < 9 or t[2] != "CDS":
            continue
        if t[0] in ("MT", "chrM", "chrMT"):
            continue
        gid = gname = pid = pver = ttype = gtype = None
        thru = canon = False
        for m in attr_re.finditer(t[8]):
            k, v = m.group(1), m.group(2)
            if k == "gene_id":
                gid = v
            elif k == "protein_id":
                pid = v
            elif k == "protein_version":
                pver = v
            elif k == "gene_name":
                gname = v
            elif k in ("transcript_biotype", "transcript_type"):
                ttype = v
            elif k in ("gene_biotype", "gene_type"):
                gtype = v
            elif k == "tag" and v == "readthrough_transcript":
                thru = True
            elif k == "tag" and v == "Ensembl_canonical":
                canon = True
        if gtype != "protein_coding":
            continue
        if canon_only and not canon:
            continue
        if excl_decay and ttype != "protein_coding":
            continue
        if not keep_thru and thru:
            continue
        gene = gname if gname is not None else gid
        if gene is None:
            raise RuntimeError("failed to parse the gene name")
        if species is not None:
            gene = "%s_%s" % (gene, species)
        prot = "%s.%s" % (pid, pver) if pver is not None else pid
        h[prot] = "%s:%s %s" % (gene, prot, t[0])
    skip = False
    for line in readlines(rest[1]):
        m = re.match(r"^>([^\s|]+)", line)
        if m:
            pid = m.group(1)
            if pid in h:
                print(">" + h[pid])
                skip = False
            else:
                sys.stderr.write('WARNING: skip "%s"\n' % pid)
                skip = True
        elif not skip:
            print(line)


def cmd_outgroup(args: List[str]) -> None:
    _, rest = _getopt(args, "")
    if len(rest) < 2:
        print("Usage: pangene-tools outgroup <call.txt> <outgroup.txt>")
        return
    outgroup = set()
    for line in readlines(rest[1]):
        parts = line.split()
        outgroup.add(parts[0] if parts else "")
    bb = None
    al = []
    ori = []
    al_re = re.compile(r"^AL\s(\d+)\s\S+\s(\S+)")
    for line in readlines(rest[0]):
        if line.startswith("BB"):
            bb = line.split("\t")
            al = []
            ori = [line]
        else:
            m = al_re.match(line)
            if m:
                n_in = n_out = 0
                for asm in m.group(2).split(","):
                    if asm in outgroup:
                        n_out += 1
                    else:
                        n_in += 1
                al.append((n_in, n_out))
                ori.append(line)
            elif line == "//":
                n_in_only = n_out_only = n_mix = 0
                for a_in, a_out in al:
                    if a_in > 0 and a_out > 0:
                        n_mix += 1
                    elif a_in > 0:
                        n_in_only += 1
                    elif a_out > 0:
                        n_out_only += 1
                tags = []
                if n_in_only + n_mix >= 2:
                    tags.append("poly_in")
                if n_out_only + n_mix >= 2:
                    tags.append("poly_out")
                if n_in_only + n_mix >= 2 and n_mix == 1:
                    tags.append("exp_in")
                if not tags:
                    tags.append("split")
                tprint("BA", bb[1], ",".join(tags))
                print("\n".join(ori))
                print("//")


def cmd_gfa2matrix(args: List[str]) -> None:
    copy_number, fn_clstr, print_cd = False, None, False
    opts, rest = _getopt(args, "cd:p")
    for o, a in opts:
        if o == "-c":
            copy_number = True
        elif o == "-d":
            fn_clstr = a
        elif o == "-p":
            print_cd = True
    if not rest:
        print("Usage: pangene-tools gfa2matrix [options] <in.gfa>")
        print("Options:")
        print("  -c        output counts")
        print("  -d FILE   CD-HIT cluster file to merge paralogs []")
        return
    g = GFA().from_file(rest[0])
    asm_h = {}
    asm_a = []
    for w in g.walk:
        if w.asm not in asm_h:
            asm_h[w.asm] = len(asm_a)
            asm_a.append(w.asm)
    mat = [[0] * len(asm_a) for _ in range(len(g.seg))]
    for w in g.walk:
        aid = asm_h[w.asm]
        for v in w.v:
            mat[v >> 1][aid] += 1
    paralog = {}
    if fn_clstr is not None:
        clstr_re = re.compile(r"^\d+\s+\S+,\s+>(\S+)\.\.\.\s+(\S+)")
        block = []

        def process(b):
            sel = -1
            if not b:
                return
            for i, (name, is_rep) in enumerate(b):
                if is_rep:
                    sel = i
            if sel >= 0:
                for i, (name, _) in enumerate(b):
                    if i == sel:
                        continue
                    paralog[name.split(":")[0]] = b[sel][0].split(":")[0]
                    if print_cd:
                        tprint(name.split(":")[0], b[sel][0].split(":")[0])

        for line in readlines(fn_clstr):
            if line.startswith(">"):
                process(block)
                block = []
            else:
                m = clstr_re.match(line)
                if m:
                    block.append((m.group(1), m.group(2) == "*"))
        process(block)
        name2id = g.segname
        for gname, pname in paralog.items():
            if gname not in name2id or pname not in name2id:
                continue
            gi, pi = name2id[gname], name2id[pname]
            for i in range(len(mat[gi])):
                mat[pi][i] += mat[gi][i]
    if not copy_number:
        for row in mat:
            for j in range(len(row)):
                if row[j] > 1:
                    row[j] = 1
    if print_cd:
        return
    tprint("Gene", "\t".join(asm_a))
    for i, row in enumerate(mat):
        if g.seg[i].name not in paralog:
            tprint(g.seg[i].name, "\t".join(map(str, row)))


def cmd_flt_mmseqs(args: List[str]) -> None:
    sim, qonly, rev = 0.9, False, False
    opts, rest = _getopt(args, "s:qv")
    for o, a in opts:
        if o == "-s":
            sim = float(a)
        elif o == "-q":
            qonly = True
        elif o == "-v":
            rev = True
    if not rest:
        print("Usage: pangene-tools flt-mmseqs [-v] [-q] [-s 0.9] "
              "<mmseqs.2.txt> | cut -f1 | uniq > filtered.txt")
        return
    for line in readlines(rest[0]):
        t = line.split("\t")
        flt = False
        if qonly:
            if float(t[2]) < sim:
                continue
            qal = int(t[7]) - int(t[6]) + 1
            qlen = int(t[12])
            if qal < qlen * sim:
                flt = True
        else:
            qlen, tlen = int(t[12]), int(t[13])
            qs, qe = int(t[6]) - 1, int(t[7])
            ts, te = int(t[8]) - 1, int(t[9])
            l0 = qs if qs < ts else ts
            l1 = min(tlen - te, qlen - qe)
            n_iden = int(t[3]) - int(t[4]) - int(t[5])
            if n_iden < (l0 + l1 + int(t[3])) * sim:
                flt = True
        if (flt and rev) or (not flt and not rev):
            print(line)


def cmd_bed2paf(args: List[str]) -> None:
    _, rest = _getopt(args, "")
    if len(rest) < 3:
        print("Usage: pangene-tools bed2paf <in.bed> <seq1.fai> <seq2.fai>")
        return
    s1 = {}
    for line in readlines(rest[1]):
        t = line.split("\t")
        s1[t[0]] = int(t[1])
    s2 = {}
    for line in readlines(rest[2]):
        t = line.split("\t")
        s2[t[0]] = int(t[1])
    h = {}
    for line in readlines(rest[0]):
        t = line.split("\t")[:6]
        k = 0 if t[0] in s1 else (1 if t[0] in s2 else -1)
        if k < 0:
            continue
        gene = t[3].split(":")[0]
        rec = t + [k]
        rec[4] = int(rec[4])
        h.setdefault(gene, []).append(rec)
    for gene, a in h.items():
        if len(a) != 2:
            continue
        n = [0, 0]
        for rec in a:
            n[rec[6]] += 1
        if n[0] != 1 or n[1] != 1:
            continue
        k = 0 if a[0][6] == 0 else 1
        l = 1 - k
        tprint(a[k][0], s1[a[k][0]], a[k][1], a[k][2],
               "+" if a[k][5] == a[l][5] else "-",
               a[l][0], s2[a[l][0]], a[l][1], a[l][2],
               min(a[k][4], a[l][4]), max(a[k][4], a[l][4]), 60,
               "pn:Z:%s" % gene)


def main(argv=None) -> int:
    import signal
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):
        pass
    args = sys.argv[1:] if argv is None else argv
    if not args:
        print("Usage: pangene-tools <command> [arguments]")
        print("Commands:")
        print("  call           call variants from a pangene graph")
        print("  call2html      generate a HTML page from call output")
        print("  calldiff       compare two call files")
        print("  bed2paf        generate PAF from a pair of samples")
        print("  gfa2matrix     generate gene_presence_absence.Rtab from pangene GFA")
        print("  getaa          generate protein files from Ensembl or GenCode annotations")
        print("  version        print version number")
        print("  flt-mmseqs     compare pangene sets in mmseqs format 2")
        return 1
    cmd, rest = args[0], args[1:]
    if cmd == "call":
        cmd_call(rest)
    elif cmd == "call2html":
        cmd_call2html(rest)
    elif cmd == "calldiff":
        cmd_calldiff(rest)
    elif cmd == "getaa":
        cmd_getaa(rest)
    elif cmd == "bed2paf":
        cmd_bed2paf(rest)
    elif cmd == "gfa2matrix":
        cmd_gfa2matrix(rest)
    elif cmd == "outgroup":
        cmd_outgroup(rest)
    elif cmd == "flt-mmseqs":
        cmd_flt_mmseqs(rest)
    elif cmd == "version":
        print(PG_VERSION + " (toolkit parity with pangene.js " + PG_REF_VERSION + ")")
    else:
        raise SystemExit("unrecognized command: " + cmd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
