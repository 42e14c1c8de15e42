"""What the kernel compare scripts share (scripts/torch_exchange_compare.py,
scripts/torch_reduce_compare.py): the card's line, this checkout's
chip_smoke.py as a module (its timers, bounds and corpora), source variants
written as textual substitutions of a source, one nvcc a source all started
together, and the builds' turns.

    from torch_compare_builds import ROOT, card_line, chip_smoke, write_variants,
        write_source, build_all, turns
"""
import importlib.util
import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def chip_smoke(name):
    """This checkout's chip_smoke.py as the module `name`."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_source(out_root, name, filename, text):
    """`text` written to out_root/name/filename; returns its path."""
    d = os.path.join(out_root, name)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, filename)
    with open(path, "w") as fp:
        fp.write(text)
    return path


def write_variants(src, subs, out_root):
    """Each variant of the source file `src` (subs: name -> substitutions
    (old, new), each old found at least once, every occurrence replaced)
    written to out_root/<name>/ under src's file name. Returns {name:
    path}."""
    with open(src) as fp:
        text = fp.read()
    paths = {}
    for name, pairs in subs.items():
        vtext = text
        for old, new in pairs:
            if old not in vtext:
                raise SystemExit("variant %s: %r not found" % (name, old))
            vtext = vtext.replace(old, new)
        paths[name] = write_source(out_root, name, os.path.basename(src),
                                   vtext)
    return paths


def build_all(sources, out_root, entry_word):
    """Each of sources (name -> .cu path) built by nvcc for the card into
    out_root/<name>/lib<name>.so, one nvcc a source, all started together;
    prints each build's ptxas lines for the entries whose name holds
    `entry_word`. Returns {name: .so path}; exits on a failed build."""
    from pangene_tpu_torch.ops.sweep_kernel import nvcc_command
    procs = {}
    for name, path in sources.items():
        d = os.path.join(out_root, name)
        os.makedirs(d, exist_ok=True)
        so = os.path.join(d, "lib%s.so" % name)
        procs[name] = (so, subprocess.Popen(
            nvcc_command(path, so), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    sos = {}
    for name, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise SystemExit("nvcc %s: %s" % (name, err[-3000:]))
        lines = err.splitlines()
        ptxas = [ln.split("'")[1][-40:] + ": " + next(
            (x.split(":", 1)[1].strip() for x in lines[i + 1:i + 5]
             if "Used" in x), "")
                 for i, ln in enumerate(lines)
                 if "Compiling entry" in ln and entry_word in ln]
        print("ptxas %s: %s" % (name, " | ".join(ptxas)), flush=True)
        sos[name] = so
    return sos


def turns(cs, launches, n):
    """The device ms of cs.TIMED_LAUNCHES launches in one CUDA graph
    (cs.graph_ms) of each of launches (name -> launch), in turns: the
    builds in order, then in reverse, n turns in all. Returns {name: [ms a
    turn]}."""
    order = list(launches)
    ms = {who: [] for who in order}
    for t in range(n):
        for who in order if t % 2 == 0 else order[::-1]:
            ms[who].append(cs.graph_ms(launches[who], cs.TIMED_LAUNCHES))
    return ms
