"""Compare the machine code of CUDA sources in two checkouts of the port.

Builds each named source of ``sgl_kernel_tpu_torch/csrc`` from both trees
with the port's own nvcc flags, disassembles both libraries with
``cuobjdump -sass`` and compares them function by function (addresses and
the library's name stripped). Needs the CUDA toolkit, so it runs on the
machine with the card:

    python tools/sass_diff.py OLD_TREE NEW_TREE w4a16_gemm grouped_gemm w4a16_gemm_dma

Prints one line per source (functions equal / differing) and exits 1 when
any function differs or exists in one tree only.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from sgl_kernel_tpu_torch import _build  # noqa: E402


def build(csrc: Path, stem: str, out: Path) -> subprocess.Popen:
    """Starts nvcc on one source (the builds run side by side)."""
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(out), str(csrc / f"{stem}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


# an anonymous namespace's mangled name holds a hash of the source's path
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def functions(lib: Path) -> dict:
    """{mangled function name: its SASS with addresses stripped}, the
    anonymous namespace's hash taken out of both."""
    text = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    funcs, name, body = {}, None, []
    for line in text.splitlines():
        line = ANON.sub("_GLOBAL__N__", line)
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            if name:
                funcs[name] = "\n".join(body)
            name, body = head.group(1), []
        elif name:
            body.append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip())
    if name:
        funcs[name] = "\n".join(body)
    return funcs


def main(argv) -> int:
    old, new, stems = Path(argv[1]), Path(argv[2]), argv[3:]
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        libs = {stem: [Path(tmp) / f"{stem}-{i}.so" for i in (0, 1)] for stem in stems}
        jobs = [build(tree / "sgl_kernel_tpu_torch" / "csrc", stem, libs[stem][i])
                for stem in stems for i, tree in enumerate((old, new))]
        for job in jobs:
            if job.wait() != 0:
                raise RuntimeError(f"nvcc failed: {job.stderr.read()}")
        for stem in stems:
            a, b = functions(libs[stem][0]), functions(libs[stem][1])
            same = sum(a[f] == b.get(f) for f in a)
            differ = sorted(f for f in a if f in b and a[f] != b[f])
            only = sorted(set(a) ^ set(b))
            print(f"{stem}: {len(a)} functions, {same} with equal SASS, {len(differ)} differ, "
                  f"{len(only)} in one tree only")
            for f in differ + only:
                print(f"  {f}")
            bad += len(differ) + len(only)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
