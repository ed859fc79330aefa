"""The latency and the instruction count of the integer operations the
recurrence can be written in, on this card.

    python -m soc_project_stereo_matching_tpu_torch.isa_probe \
        [--out chiprun_out/isa_probe.json]

Builds a small CUDA program with ``nvcc`` (under ``build/isa_probe/``) in
which one warp runs a chain of 512 dependent applications of one operation
(``x = op(x, y)``, ``y`` changed every step off the chain) and reads the
SM clock around it; prints the cycles per dependent step of each operation
and, from ``cuobjdump -sass``, the instructions one application compiles
to (the loop is unrolled 16 times: the count beyond the xor kernel's, over
16, plus one).  The operations: the 16-bit-lane forms the chain
kernel (``csrc/probe_recurrence.cu``) uses (``__vminu2``,
``__viaddmin_u16x2``, ``__vimin3_u16x2``, ``__byte_perm``), the byte-lane
forms of a four-disparities-to-a-register design (``__vminu4``,
``__vaddus4``, ``__vadd4``), a 32-bit add and xor, a shuffle and a
``REDUX.MIN`` (each with the xor that joins ``y``).  Needs one CUDA
device; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

from . import _build

OPS = {  # name -> expression of x and y
    "xor": "x ^ y",
    "add": "x + y",
    "__vminu2": "__vminu2(x, y)",
    "__viaddmin_u16x2": "__viaddmin_u16x2(x, y, y)",
    "__vimin3_u16x2": "__vimin3_u16x2(x, y, y)",
    "__byte_perm": "__byte_perm(x, y, 0x5432)",
    "__vminu4": "__vminu4(x, y)",
    "__vaddus4": "__vaddus4(x, y)",
    "__vadd4": "__vadd4(x, y)",
    "__shfl_xor_sync": "__shfl_xor_sync(0xffffffffu, x, 1) ^ y",
    "__reduce_min_sync": "__reduce_min_sync(0xffffffffu, x) ^ y",
}
STEPS = 512


def source() -> str:
    kernels = "\n".join(
        f'extern "C" __global__ void op{i}(unsigned* out, long long* cyc) {{\n'
        f"  unsigned x = 3u * (threadIdx.x + 1), y = 3u ^ threadIdx.x;\n"
        f"  const long long t0 = clock64();\n"
        f"#pragma unroll 16\n"
        f"  for (int i = 0; i < {STEPS}; ++i) {{\n"
        f"    y = y * 0x9E3779B1u + 7u;\n"
        f"    x = {expr};\n"
        f"  }}\n"
        f"  const long long t1 = clock64();\n"
        f"  out[threadIdx.x] = x;\n"
        f"  if (threadIdx.x == 0) *cyc = t1 - t0;\n"
        f"}}\n" for i, expr in enumerate(OPS.values()))
    calls = "\n".join(
        f"  op{i}<<<1, 32>>>(out, cyc); op{i}<<<1, 32>>>(out, cyc);\n"
        f"  cudaMemcpy(&h, cyc, 8, cudaMemcpyDeviceToHost);\n"
        f'  printf("op{i} %f\\n", (double)h / {STEPS});'
        for i in range(len(OPS)))
    return (f"#include <cstdio>\n#include <cuda_runtime.h>\n{kernels}\n"
            f"int main() {{\n  unsigned* out; long long* cyc; long long h;\n"
            f"  cudaMalloc(&out, 128); cudaMalloc(&cyc, 8);\n{calls}\n"
            f"  return cudaDeviceSynchronize() != cudaSuccess;\n}}\n")


def sass_counts(sass: str) -> dict:
    """{kernel: instructions other than NOP, BRA and EXIT} of a cuobjdump
    listing."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = part.split("\n", 1)
        lines = [line for line in body.split("\n")
                 if re.search(r"/\*[0-9a-f]{4}\*/", line)]
        out[name.strip()] = sum(
            1 for line in lines if not re.search(r"\b(NOP|BRA|EXIT)\b", line))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/isa_probe.json")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("isa_probe: needs a CUDA device")
    from .utils.profiling import card

    nvcc = _build._nvcc()
    work = _build.BUILD_DIR.parent / "isa_probe"
    work.mkdir(parents=True, exist_ok=True)
    (work / "isa.cu").write_text(source())
    arch = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3")
    subprocess.run([nvcc, *arch, "-o", str(work / "isa"), str(work / "isa.cu")],
                   check=True)
    run = subprocess.run([str(work / "isa")], capture_output=True, text=True,
                         check=True).stdout
    cycles = dict(zip(OPS, (float(l.split()[1]) for l in run.split("\n") if l)))
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(work / "isa")],
                          capture_output=True, text=True, check=True).stdout
    counts = sass_counts(sass)
    result = {"card": ", ".join(card()), "steps": STEPS, "ops": {
        name: {"cycles_per_dependent_step": cycles[name],
               "instructions": 1 + (counts[f"op{i}"] - counts["op0"]) / 16}
        for i, name in enumerate(OPS)}}
    print(result["card"])
    for name, rec in result["ops"].items():
        print(f"{name:20s} {rec['cycles_per_dependent_step']:7.2f} cycles a "
              f"dependent step, {rec['instructions']:.2f} instructions")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
