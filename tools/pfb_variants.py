"""Time design variants of the bf16 chunked PFB front
(csrc/fronts.cuh, pfb_front_mma_chunked) on one NVIDIA GPU, against this
checkout, in one process tree each, in turns.

As tools/dense_variants.py, with the variants below and
`tools/probe_grades.py pfb_mma` as the probe: a variant is a copy of this
checkout's package, chip_smoke.py and tools/ under build/variants/<name>
with one edit to the CUDA sources; every tree builds first, all at once;
each round runs the probe in this checkout and in each variant's tree and
prints its JSON lines with a "variant" key. The ablations (no_stage,
no_fold, no_product) drop one part of a chunk's work and give wrong
outputs: they are timed only, to split a chunk's time.

Usage, from the repository root:
    python3 tools/pfb_variants.py [--rounds N] [variant ...]
(no variant: all of them).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import dense_variants  # noqa: E402

PRODUCT_CALL = ("    pfb_mma_product<kGrade, kNT, kNw, kRows>(\n"
                "        d, a + (c & 1) * atile, bs + (c & 1) * bsize,")
FOLD_CALL = ("    pfb_mma_fold<kGrade, kRows, kSplit>(\n"
             "        a + (c & 1) * atile, st + tsize,")
B_COPY = ("    if (group * kNT + e / 16 < NT)\n"
          "      cp_async_16(dst, reinterpret_cast<const float*>(\n"
          "                           btab + ((long)(part * KBg + kbg0")

# name: [(source under csrc/, text, replacement)]
VARIANTS = {
    # the window's phase pairs nfr frames apart, rounded up to 16 bytes
    # (not to 8 mod 16 frames)
    "stride_2": [("fronts.cuh", "return nfr + (24 - nfr % 16) % 16;",
                  "return (nfr + 1) / 2 * 2;")],
    # 4-byte copies of the window only (no 8-byte copies of a pair)
    "copy_4": [("fronts.cuh", "const bool vec = D % 2 == 0 &&",
                "const bool vec = false && D % 2 == 0 &&")],
    # the fold's loop over taps unrolled by 4
    "fold_unroll4": [("fronts.cuh",
                      "#pragma unroll 1\n    for (; u < nu; ++u) {",
                      "#pragma unroll 4\n    for (; u < nu; ++u) {")],
    # no sliding-window fold at P = 4, Q = 4: a load a product
    "no_slide": [("fronts.cuh",
                  "P == 4 && Q == 4 && nu == 4 && s.ka + 8 * kb + 8 <= s.kz;",
                  "false;")],
    # the product's loop over 8-lane blocks unrolled by 2 at every row
    # tile (below 256 rows it is)
    "product_unroll2": [("fronts.cuh",
                         "  } else {\n"
                         "    for (int kb = 0; kb < nk; ++kb)\n",
                         "  } else {\n"
                         "#pragma unroll 2\n"
                         "    for (int kb = 0; kb < nk; ++kb)\n")],
    # ablations, timed only: no copies of taps, window or B rows; no
    # fold; no product
    "no_stage": [("fronts.cuh", "    pfb_mma_stage_window(st + tsize,",
                  "    if (false)\n    pfb_mma_stage_window(st + tsize,"),
                 ("fronts.cuh",
                  "      cp_async_16(st + u * tl + 4 * e, "
                  "src + (long)u * tq + 4 * e);",
                  "      if (false) cp_async_16(st + u * tl + 4 * e, "
                  "src + (long)u * tq + 4 * e);"),
                 ("fronts.cuh", B_COPY,
                  B_COPY.replace("if (group * kNT + e / 16 < NT)",
                                 "if (false)"))],
    "no_fold": [("fronts.cuh", FOLD_CALL, "    if (false)\n" + FOLD_CALL)],
    "no_product": [("fronts.cuh", PRODUCT_CALL,
                    "    if (false)\n" + PRODUCT_CALL)],
}
# each role alone: the consumers' B copies and product (no producer
# staging or fold), the producers' staging and fold (no B, no product)
VARIANTS["consumers_only"] = VARIANTS["no_stage"][:2] + VARIANTS["no_fold"]
VARIANTS["producers_only"] = VARIANTS["no_stage"][2:] + VARIANTS[
    "no_product"]

if __name__ == "__main__":
    sys.exit(dense_variants.main(VARIANTS, "pfb_mma", __doc__))
