"""Registers, shared memory and spills of the port's CUDA kernels, and the
tensor-core instructions in their machine code.

    python3 tools/kernel_resources.py [name.cu ...]

Compiles each source under sr_object_detection_tpu_torch/csrc (all of
them without arguments) with the flags of kernels/_build.py plus
``-Xptxas -v``, prints what ptxas reports for each kernel, then
disassembles the object with ``cuobjdump -sass`` and prints, per kernel,
the count of tensor-core instructions (HMMA: bf16 / fp16 mma.sync and
wgmma; IMMA: int8 mma.sync) and of SASS instructions in all. Needs the
CUDA toolkit (nvcc and cuobjdump); runs no kernel and needs no card.
"""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from sr_object_detection_tpu_torch.kernels import _build  # noqa: E402


def sass_counts(obj: str,
                cuobjdump: str) -> dict[str, tuple[int, int, int]]:
    """kernel (mangled) -> (HMMA, IMMA, all instructions)."""
    text = subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = (0, 0, 0)
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            hmma, imma, total = out[fn]
            out[fn] = (hmma + (" HMMA" in line), imma + (" IMMA" in line),
                       total + 1)
    return out


def main(argv: list[str]) -> int:
    nvcc = _build._nvcc()
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    sources = ([_build.CSRC / a for a in argv] if argv
               else _build._sources())
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources:
            obj = str(pathlib.Path(tmp) / (src.stem + ".o"))
            res = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                 "-o", obj], capture_output=True, text=True)
            print(f"== {src.name}: ptxas -v")
            print((res.stdout + res.stderr).strip())
            if res.returncode != 0:
                return res.returncode
            print(f"== {src.name}: SASS (kernel: HMMA, IMMA / "
                  f"instructions)")
            for fn, (hmma, imma, total) in sass_counts(
                    obj, cuobjdump).items():
                print(f"{fn}: HMMA {hmma}, IMMA {imma} / {total}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
