#!/usr/bin/env python3
"""Print what ptxas and the SASS say about the port's CUDA kernels.

Run from the root of a checkout of the port on a machine with the CUDA
toolkit (no card needed):

    python3 tools/torch_kernel_resources.py [SOURCE ...] [--sass-grep HGMMA]

Each named source of mic_tpu_torch/csrc (default: all) is compiled alone
with the build's flags and -Xptxas -v into build/resources/, and for every
kernel the registers, shared memory, stack frame and spill bytes that
ptxas reports are printed, one line each, with its warnings and its
wgmma advisories (C7517: a warpgroup.wait injected before a use of
registers a wgmma defines, so a product group meant to stay in flight
does not; C7518/C7520: wgmma instructions serialized).  With
--sass-grep, the object's SASS (cuobjdump --dump-sass) is searched for
the instruction names, and for each kernel function their count is
printed beside its number of instructions, with each distinct form of the
matching instructions (the opcode and its operands with register numbers
dropped) and how often it occurs: a wgmma reading both operands from shared memory shows as
``HGMMA... R, gdesc[UR], R``, one whose A is in registers as ``HGMMA... R,
R, gdesc[UR], R``, and a warp-level mma.sync (WMMA) as ``HMMA``.  For
int8_matmul.cu (row 20), whose blocks take dynamic shared memory only, the
bytes a block of each instance takes are printed too (the source's
``mic_int8_matmul_shared_bytes``, from the object linked alone).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))

from mic_tpu_torch import _build  # noqa: E402


def demangled(name: str) -> str:
    found = shutil.which("cu++filt") or str(Path(_build._nvcc()).parent / "cu++filt")
    try:
        return subprocess.run([found, name], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return name


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="*")
    parser.add_argument("--sass-grep", default=None, help="a regular expression")
    args = parser.parse_args()
    csrc = ROOT / "mic_tpu_torch" / "csrc"
    sources = [csrc / s for s in args.sources] or sorted(csrc.glob("*.cu"))
    out = ROOT / "build" / "resources"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    for src in sources:
        obj = out / f"{src.stem}.o"
        done = subprocess.run([nvcc, *_build._FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
                               str(src)], capture_output=True, text=True)
        if done.returncode != 0:
            raise SystemExit(f"nvcc failed on {src.name}:\n{done.stderr}")
        kernel = None
        for line in done.stderr.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                kernel = demangled(m.group(1))
                continue
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                kernel = demangled(m.group(1))
            if "stack frame" in line or "Used" in line:
                print(f"{src.name}: {kernel}: {line.strip()}", flush=True)
            elif "warning" in line.lower() or re.search(r"\(C75\d\d\)", line):
                print(f"{src.name}: {line.strip()}", flush=True)
        if src.stem == "int8_matmul":
            lib = out / "int8_matmul.so"
            subprocess.run([nvcc, *_build._FLAGS, "-shared", "-o", str(lib), str(obj)], check=True)
            shared = ctypes.CDLL(str(lib)).mic_int8_matmul_shared_bytes
            shared.argtypes = _build._SIGNATURES["mic_int8_matmul_shared_bytes"]
            for rows in (8, 64, 256):
                for tma in (1, 0):
                    print(f"{src.name}: dq_kernel<{rows}, {bool(tma)}>: {shared(rows, tma)} bytes "
                          "of dynamic shared memory a block", flush=True)
        if args.sass_grep:
            cuobjdump = Path(nvcc).parent / "cuobjdump"
            sass = subprocess.run([str(cuobjdump), "--dump-sass", str(obj)], capture_output=True,
                                  text=True, check=True).stdout
            counts, sizes, forms, func = {}, {}, {}, None
            for line in sass.splitlines():
                m = re.search(r"Function : (\S+)", line)
                if m:
                    func = demangled(m.group(1))
                    counts.setdefault(func, 0)
                    sizes.setdefault(func, 0)
                    forms.setdefault(func, {})
                elif func and re.search(r"/\*[0-9a-f]{4,}\*/", line):
                    sizes[func] += 1
                    if re.search(rf"\b(?:{args.sass_grep})\b", line):
                        counts[func] += 1
                        text = re.sub(r"\s*/\*.*?\*/\s*", " ", line).strip().rstrip(" ;")
                        form = re.sub(r"\b(U?R|U?P)\d+\b", r"\1", text)
                        forms[func][form] = forms[func].get(form, 0) + 1
            for func, count in counts.items():
                seen = "; ".join(f"{n} x {form}" for form, n in forms[func].items())
                print(f"{src.name}: SASS {args.sass_grep} x{count} of {sizes[func]} instructions "
                      f"in {func}" + (f": {seen}" if seen else ""), flush=True)

if __name__ == "__main__":
    main()
