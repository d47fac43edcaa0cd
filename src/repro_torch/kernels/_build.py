"""Builds the package's CUDA sources into shared libraries.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/lib<name>_<digest>.so`` at the root
of the checkout, at first use, and loaded with ``ctypes``; the headers
``csrc/*.cuh`` are on the include path.  The digest is of the source
text and of every header's, so an edited source or header never meets
a stale library.  Every source is compiled to an object and each
library linked from its objects: most libraries are one source, and
``SOURCES`` names those of several (K4's forward and each backward
pair, each with its softcap instantiations), whose digest covers every
one.  Sources that are
asked for together are compiled together, one ``nvcc`` process each.
While tracing is on, every library built adds one to the
``kernel.builds`` counter and its seconds to the
``kernel.build_s`` histogram (the port's counterpart of a backend
compile); a build that finds its library recorded nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from time import perf_counter
from typing import Dict, Sequence

from repro_torch.obs import telemetry as obs

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
# --split-compile=0: each nvcc optimizes its kernels on as many threads
# as the machine has CPUs; the attention sources' many instantiations
# then build in about 13 s where one thread took 21 on an H100 machine
# of 8 cores (PERF.md)
# (a source to an object with "-c" and the library linked with
# "-shared", or a source straight to a library with "-shared")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--split-compile=0",
              f"-I{CSRC}")

# the libraries built from more than one source, in link order; any
# other library ``<name>`` is ``csrc/<name>.cu`` alone
SOURCES = {"flash_attention": ("flash_attention", "flash_attention_softcap"),
           "flash_attention_bwd": ("flash_attention_bwd",
                                   "flash_attention_bwd_softcap"),
           "flash_attention_bwd_tc": ("flash_attention_bwd_tc",
                                      "flash_attention_bwd_tc_softcap")}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of repro_torch cannot be built here")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in SOURCES.get(name, (name,)):
        h.update((CSRC / f"{src}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile the named sources that have no library yet, all at once,
    and return name -> library path.  Raises with the compiler's output
    when a build fails."""
    targets = {n: _target(n) for n in names}
    missing = [n for n, t in targets.items() if not t.exists()]
    if missing:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = perf_counter()
        tag = f".{os.getpid()}.tmp"
        procs = []                 # (library, object, process) a source
        for n in missing:
            for src in SOURCES.get(n, (n,)):
                out = BUILD_DIR / f"{src}{tag}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(out),
                       str(CSRC / f"{src}.cu")]
                procs.append((n, out, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        failures = []
        for n, out, proc in procs:
            text, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{out.name} (exit {proc.returncode}):\n"
                                f"{text}")
        for n in missing:
            outs = [out for m, out, _ in procs if m == n]
            tmp = targets[n].with_suffix(tag)
            if not failures:
                link = subprocess.Popen(
                    [nvcc, "-shared", "-o", str(tmp), *map(str, outs)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                text, _ = link.communicate()
                if link.returncode != 0:
                    failures.append(f"link of {n} (exit {link.returncode}):"
                                    f"\n{text}")
            if failures:
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, targets[n])   # atomic: never a half file
                tel = obs.TEL
                if tel.enabled:
                    tel.inc("kernel.builds")
                    tel.observe("kernel.build_s", perf_counter() - t0)
            for out in outs:
                out.unlink(missing_ok=True)
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib
