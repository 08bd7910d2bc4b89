"""Time ablations of the FM chain's one-launch back end
(csrc/fm_chain.cu: the de-emphasis look-back of fm_chain_tile) on one
NVIDIA GPU, against this checkout, in one process tree each, in turns.

As tools/dense_variants.py, with the variants below and
`tools/probe_grades.py back_end_quick` as the probe (the flagship at
bf16x3 and f32, fm_rx, the long filter and B2 at D=8). The ablations give
wrong outputs and are timed only, to split the look-back's cost:
no_look_back takes no start state (the block polls its window and walks
nothing), stop_at_one stops every look-back at the tile before (it waits
for one predecessor, not for every tile up to the composed power's 0).
The others keep the outputs: sleep200 polls a missing state every 200
ns, min1 lifts the one-chunk dense blocks' bound of 1024 threads a SM
(64 registers).

Usage, from the repository root:
    python3 tools/back_end_variants.py [--rounds N] [variant ...]
(no variant: all of them).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import dense_variants  # noqa: E402

# name: [(source under csrc/, text, replacement)]
VARIANTS = {
    "no_look_back": [("fm_chain.cu",
                      "    if (tid < kCh) {\n      z_start[tid] = cg + tid < C",
                      "    if (false) {\n      z_start[tid] = cg + tid < C")],
    "stop_at_one": [("fm_chain.cu", "    P *= A;\n    const long s",
                     "    P = m > 1 ? 0.f : P * A;\n    const long s")],
    # a poll for a missing state sleeps 200 ns, not 20, between loads
    "sleep200": [("lookback.cuh",
                  "  if (clock64() - t0 > kMaxSpinClocks) __trap();\n"
                  "  __nanosleep(20);",
                  "  if (clock64() - t0 > kMaxSpinClocks) __trap();\n"
                  "  __nanosleep(200);")],
    # the one-chunk dense blocks without their bound of 1024 threads a SM
    "min1": [("fm_chain.cu",
              "    !kPfb && !kChunked ? 1024 / gsdr::back_threads(kCh) : 1)",
              "    1)")],
}

if __name__ == "__main__":
    sys.exit(dense_variants.main(VARIANTS, "back_end_quick", __doc__))
