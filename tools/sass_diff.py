"""Compares the machine code of a kernel between two checkouts, on a
machine with the CUDA toolkit (no GPU needed):

    python tools/sass_diff.py OLD NEW SOURCE OLD_KERNEL=NEW_KERNEL [...]

OLD and NEW are roots of checkouts of the repository (for example a
parent commit unpacked with ``git archive`` into a directory that
.gitignore lists, and this one).  Each one's ``taper_tpu_torch/csrc/SOURCE``
is compiled with the flags of ``taper_tpu_torch/ops/_build.py``
(NVCC_FLAGS, ptxas's register report included).  Each pair names a kernel
of each build by its demangled name, spaces removed (for example
``taper::flash::sm90::dkv_kernel<128,false>=taper::flash::sm90::dkv_kernel<128,false,false>``).
For each pair it prints ptxas's report of both (registers, stack, spills)
and whether their SASS instructions are the same, addresses and
encodings aside, with the first lines that differ.  The last line of the
output is one JSON object: ``{"pair": {"same_sass", "old", "new"}}``,
the last two ptxas's report lines.
"""

import difflib
import json
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from taper_tpu_torch.ops import _build  # noqa: E402


def _tool(name):
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(found).exists():
        raise RuntimeError(f"{name} not found (the CUDA toolkit's)")
    return found


def _short(name):
    """A demangled kernel name without its parameter list, return type
    and spaces, template arguments as written in the source:
    ``void f<(int)128, (bool)0>(...)`` -> ``f<128,false>``."""
    depth, i = 0, len(name)
    while name.endswith(")") and i > 0:
        i -= 1
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            name = name[:i]
    name = re.sub(r"^void ", "", name).replace(" ", "")
    name = re.sub(r"\(bool\)0", "false", name)
    name = re.sub(r"\(bool\)1", "true", name)
    return re.sub(r"\((?:int|unsigned int)\)(-?\d+)", r"\1", name)


def _demangle(names):
    out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.splitlines()
    return {m: _short(d) for m, d in zip(names, out)}


def compile_source(root, source, obj):
    """nvcc with the build's flags; returns ptxas's report by kernel."""
    src = Path(root) / "taper_tpu_torch" / "csrc" / source
    text = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        check=True, timeout=900).stdout
    report, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            report[name] = []
        elif name and ("bytes stack frame" in line or "Used" in line):
            report[name].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in report.items()}


def sass(obj):
    """The SASS of each kernel of ``obj``: its instructions, addresses
    and encodings dropped."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(obj)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if name and m:
            out[name].append(m.group(1))
    return out


def main():
    old, new, source, *pairs = sys.argv[1:]
    with tempfile.TemporaryDirectory() as tmp:
        objs = [Path(tmp) / f"{tag}.o" for tag in ("old", "new")]
        with ThreadPoolExecutor(2) as pool:
            reports = list(pool.map(compile_source, (old, new),
                                    (source, source), objs))
        codes = [sass(o) for o in objs]
    names = [_demangle(list(c)) for c in codes]
    result = {}
    for pair in pairs:
        want = pair.split("=")
        found = []
        for code, nm, rep, w in zip(codes, names, reports, want):
            mangled = [m for m, d in nm.items() if d.endswith(w)]
            if len(mangled) != 1:
                raise SystemExit(f"{w}: {len(mangled)} kernels match "
                                 f"(of {sorted(nm.values())})")
            found.append((code[mangled[0]], rep.get(mangled[0], "")))
        (a, ra), (b, rb) = found
        same = a == b
        print(f"{pair}:\n  old: {ra}\n  new: {rb}\n  SASS: {len(a)} vs "
              f"{len(b)} instructions, same: {same}")
        if not same:
            for line in list(difflib.unified_diff(a, b, lineterm="",
                                                  n=1))[:40]:
                print("   ", line)
        result[pair] = dict(same_sass=same, old=ra, new=rb)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
