"""Write ``wgmma_bf16.cuh``: one inline-PTX wrapper per wgmma width.

A ``wgmma.mma_async`` names every accumulator register of its thread as
an operand (N / 2 of them for an m64nNk16 f32 product), so each width is
its own asm statement.  This script writes them; the header is committed
and built like any other source.

    python3 src/repro_torch/kernels/csrc/gen_wgmma.py
"""
from pathlib import Path

# Widths (the C tile of moe_gmm.cu): every multiple of 8 up to 64 for the
# narrow buckets, then the wide tiles.
WIDTHS = (8, 16, 24, 32, 40, 48, 56, 64, 128, 192, 256)

HEAD = """\
// Generated by gen_wgmma.py; do not edit.
//
// Wgmma<N>::mma(d, desc_a, desc_b): d += A * B for one m64nNk16 bf16
// product with f32 accumulators, A and B read from shared memory through
// the descriptors.  A is M-major (imm-trans-a 1), B is K-major
// (imm-trans-b 0).  d holds the thread's N / 2 accumulators in wgmma's
// fragment order.
#pragma once

#include <stdint.h>

template <int N> struct Wgmma;
"""


def wrapper(n: int) -> str:
    regs = n // 2
    outs = ", ".join(f"%{i}" for i in range(regs))
    cons = ",\n        ".join(
        ", ".join(f'"+f"(d[{j}])' for j in range(i, min(i + 8, regs)))
        for i in range(0, regs, 8))
    return f"""
template <> struct Wgmma<{n}> {{
  static __device__ __forceinline__ void mma(float (&d)[{regs}], uint64_t desc_a,
                                             uint64_t desc_b) {{
    asm volatile(
        "{{\\n"
        ".reg .pred p;\\n"
        "setp.ne.b32 p, %{regs + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{outs}}}, %{regs}, %{regs + 1}, p, 1, 1, 1, 0;\\n"
        "}}\\n"
        : {cons}
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }}
}};
"""


def main() -> None:
    out = Path(__file__).resolve().parent / "wgmma_bf16.cuh"
    out.write_text(HEAD + "".join(wrapper(n) for n in WIDTHS))


if __name__ == "__main__":
    main()
