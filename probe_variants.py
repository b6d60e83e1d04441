"""Variant builds for the kernel probes (probe_an_direct.py,
probe_an_gates.py), not part of the smoke run.

A variant is a copy of one CUDA source of opengl_raytracing_tpu_torch/csrc
and of every header there, with text patches applied: a list of (file,
text, its replacement), each text found exactly once in its file; a name
A+B applies A's patches and B's.  build() writes each variant's files to
a directory of its own under the build directory (so that the source's
#include finds the variant's headers), starts one nvcc for each, all
together, and binds each library's C entries through ctypes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import chip_smoke as cs


def patched(source, patches):
    """{file name: text} of csrc/`source` and every csrc header with
    `patches` applied."""
    from opengl_raytracing_tpu_torch.ops import cuda_lib
    files = {}
    for f in sorted(os.listdir(cuda_lib._CSRC)):
        if f.endswith(".cuh") or f == source:
            with open(os.path.join(cuda_lib._CSRC, f)) as fh:
                files[f] = fh.read()
    for f, old, new in patches:
        if files[f].count(old) != 1:
            raise RuntimeError(f"{f} no longer holds {old!r} once")
        files[f] = files[f].replace(old, new)
    return files


def build(probe, source, signatures, kernels, variants, names):
    """{name: (library, {key: ptxas record})} of the variants `names` of
    csrc/`source` and of the source itself ("base"), built under the build
    directory's `probe` folder.  `variants` maps a name to its patches,
    `signatures` each C entry to bind to its (argtypes, restype), and
    `kernels` a key to the __global__ function whose ptxas record (its
    registers, spill and shared memory) is kept."""
    from opengl_raytracing_tpu_torch.ops import cuda_lib
    procs = {}
    for name in ("base",) + tuple(names):
        patches = [] if name == "base" else [
            p for part in name.split("+") for p in variants[part]]
        where = os.path.join(cuda_lib.BUILD_DIR, probe, name)
        shutil.rmtree(where, ignore_errors=True)
        os.makedirs(where)
        for f, body in patched(source, patches).items():
            with open(os.path.join(where, f), "w") as fh:
                fh.write(body)
        lib = os.path.join(where, source[:-3] + ".so")
        procs[name] = (lib, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", where, "-o", lib,
             os.path.join(where, source)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        with open(lib[:-3] + ".log", "w") as fh:
            fh.write(log)
        handle = ctypes.CDLL(lib)
        for entry, (argtypes, restype) in signatures.items():
            getattr(handle, entry).argtypes = argtypes
            getattr(handle, entry).restype = restype
        libs[name] = (handle, {k: cs.ptxas_of(lib[:-3] + ".log", v)
                               for k, v in kernels.items()})
    return libs


def options(variants, rounds):
    """(variant names, rounds) from the command line's `--variants
    NAME,A+B,...` (every variant by default) and `--rounds N` (`rounds` by
    default); an unknown name exits."""
    argv = sys.argv
    names = list(variants)
    if "--variants" in argv:
        names = argv[argv.index("--variants") + 1].split(",")
    for name in names:
        if not all(part in variants for part in name.split("+")):
            raise SystemExit(f"unknown variant {name}")
    if "--rounds" in argv:
        rounds = int(argv[argv.index("--rounds") + 1])
    return names, rounds


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def turn_order(names):
    """One round's order of the libraries: base, the variants, the
    variants reversed, base (drift on the card falls on both sides)."""
    return ["base"] + list(names) + list(names)[::-1] + ["base"]
