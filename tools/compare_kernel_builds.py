#!/usr/bin/env python3
"""Compare two checkouts' builds of the port's CUDA kernel library,
function by function: registers and spill bytes (each build's ptxas
report) and the SASS (cuobjdump), so a change that adds instantiations can
show that the ones already serving are the same code.

    python3 tools/compare_kernel_builds.py OLD_CHECKOUT NEW_CHECKOUT \\
        [--match REGEX] [--out FILE]

Needs nvcc and cuobjdump (CUDA_HOME or /usr/local/cuda). Each checkout's
own `src/repro_torch/kernels/build.py` builds its library into that
checkout's `build/`. Functions are paired by their mangled names with the
anonymous-namespace tags (which depend on the build) removed; an old
decode kernel `decode_kernel<kVec16, TKV>` is paired with the new
`decode_kernel<128, 2, kVec16, TKV>`, the shape that serves the same
calls, and an old `flash_wide_kernel<ND, NV, kVec16, float>` with the
new `flash_wide_kernel<ND, NV, kVec16>`. SASS lines are compared with
their addresses and encodings removed. Prints one line for each old
function (the same, differing, or missing from the new build) and exits
1 unless all are the same.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

# an anonymous namespace's tag: two 8-digit hashes around the file name
TAG = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")
# the decode kernels before their shape became template parameters, and
# the shape that now serves the same calls (head dims <= 128, G <= 8)
RENAMES = ((re.compile(r"(\d+(?:paged_)?decode_kernelI)(Lb\d)"),
            r"\1Li128ELi2E\2"),
           # the f32 wide kernel before its value type (only float was ever
           # instantiated) left its template parameters
           (re.compile(r"(flash_wide_kernelI(?:Li\d+E)+Lb\dE)f(?=E)"), r"\1"))


def build(checkout: Path) -> tuple:
    """Build `checkout`'s library; its path and its ptxas report."""
    env = dict(os.environ, PYTHONPATH=str(checkout / "src"))
    out = subprocess.run(
        [sys.executable, "-c", "from repro_torch.kernels import build; "
         "print(build.build()); print(build.BUILD_DIR / 'build.log')"],
        env=env, capture_output=True, text=True, check=True)
    lib, log = out.stdout.split()[-2:]
    return Path(lib), Path(log).read_text()


def name_key(name: str, old: bool) -> str:
    name = TAG.sub("", name)
    if old:
        for pat, rep in RENAMES:
            name = pat.sub(rep, name)
    return name


def ptxas(log: str, old: bool) -> dict:
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = out.setdefault(name_key(m.group(1), old), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            cur = None
    return out


def sass(lib: Path, old: bool) -> dict:
    cuda = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    dump = subprocess.run([str(cuda / "bin" / "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in dump.split("Function : ")[1:]:
        head, body = part.split("\n", 1)
        lines = []
        for ln in body.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", ln)
            if m:   # calls name a subroutine after its kernel
                lines.append(name_key(m.group(1), old))
        out[name_key(head.strip(), old)] = lines
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--match", default="flash_fwd|decode",
                    help="compare the functions whose name matches this")
    ap.add_argument("--out", type=Path, help="write the table as JSON here")
    args = ap.parse_args(argv)
    (old_lib, old_log), (new_lib, new_log) = build(args.old), build(args.new)
    regs = ptxas(old_log, True), ptxas(new_log, False)
    code = sass(old_lib, True), sass(new_lib, False)
    rows, differ = {}, 0
    for name in sorted(code[0]):
        if not re.search(args.match, name):
            continue
        a, b = code[0][name], code[1].get(name)
        same = b is not None and a == b
        differ += not same
        rows[name] = dict(
            sass_lines=len(a), same_sass=same, in_new=b is not None,
            old_registers=regs[0].get(name, {}).get("registers"),
            new_registers=regs[1].get(name, {}).get("registers"),
            old_spill=regs[0].get(name, {}).get("spill"),
            new_spill=regs[1].get(name, {}).get("spill"))
        r = rows[name]
        verdict = "same" if same else "DIFFERS" if b else "MISSING"
        print(f"{verdict}: {name}: {len(a)} SASS "
              f"lines, registers {r['old_registers']} -> "
              f"{r['new_registers']}, spill {r['old_spill']} -> "
              f"{r['new_spill']}")
        if b is not None and not same:
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            print(f"  {len(b)} lines now; first difference at line {i}: "
                  f"{a[i] if i < len(a) else None!r} -> "
                  f"{b[i] if i < len(b) else None!r}")
    print(f"{len(rows)} functions of the old build, {differ} differ or "
          f"are missing from the new one")
    if args.out:
        args.out.write_text(json.dumps(rows, indent=1, sort_keys=True))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
