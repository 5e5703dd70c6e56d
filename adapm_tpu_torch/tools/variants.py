"""Text-edited variants of a kernel of the port, built and swapped in
so that the public wrapper runs them, for timing on one CUDA card.

A variant is the kernel's source (`csrc/<file>`) with a few exact string
edits; `edit` asserts each, so a stale variant fails loudly once the
source changes. `build` compiles every variant with ops/kernels.py's
nvcc line, all at once, and binds each with `kernels._bind`; a variant
runs once it is put into `kernels._libs`. The kernels' own cases and
loops:

    python -m adapm_tpu_torch.tools.k4_variants
    python -m adapm_tpu_torch.tools.k8_variants [--only NAME,...]
        [--extra NAME=PATH ...]
"""
import ctypes
import os
import re
import subprocess

from adapm_tpu_torch.ops import kernels as K

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def source(name):
    """The text of csrc/<name>."""
    with open(os.path.join(ROOT, "adapm_tpu_torch", "csrc", name)) as fh:
        return fh.read()


def edit(s, pairs):
    """s with each (old, new) replaced; every old must occur."""
    for a, b in pairs:
        assert a in s, a
        s = s.replace(a, b)
    return s


def const(name, old, new):
    """The edit of one `constexpr int` of a source."""
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


def ptxas_entries(log):
    """[(entry, spill store bytes, registers)] from an `-Xptxas -v` log;
    a template entry is named by its arguments (`kernelI...EEv`)."""
    out = []
    for m in re.finditer(r"Compiling entry function '(\S+)'(.*?)Used (\d+) "
                         r"registers", log, re.S):
        tpl = re.search(r"kernelI(.*)EEv", m.group(1))
        spill = re.search(r"(\d+) bytes spill stores", m.group(2))
        out.append((tpl.group(1) if tpl else m.group(1),
                    int(spill.group(1)) if spill else 0, int(m.group(3))))
    return out


def build(kernel, variants, out_dir):
    """Compile each variant (name -> source text) into out_dir, all at
    once; returns name -> library bound as `kernel`, after printing each
    one's ptxas entries."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as fh:
            fh.write(text)
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            K.nvcc_command(src, so), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(f"{name}: ptxas (entry, spill bytes, registers) "
              f"{ptxas_entries(log)}", flush=True)
        libs[name] = K._bind(kernel, ctypes.CDLL(so))
    return libs


def card():
    """The card's name and power limit."""
    return _smi("name,power.limit")


def clocks():
    """The card's SM clock and power draw now."""
    return _smi("clocks.sm,power.draw")


def _smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
