"""Where the FM chain's one-launch back end waits (csrc/fm_chain.cu): a
timeline of every tile block of one B1 call on one NVIDIA GPU.

Makes a copy of this checkout under build/variants/timeline whose
fm_chain_tile has thread 0 read the GPU's global timer (ns) when its
block has its ticket (t0), when the block's aggregate is out (t1), when
its start state is known (t2) and at its end (t3), and write them and
its SM over its tile's first outputs of channel 0 (the outputs are then
wrong: the run is timed only). It runs the flagship at bf16x3 and f32 and
fm_rx's receiver in that tree and prints, per path, the device time of a
call and, over the call's blocks: their time (t3 - t0), the front to the
scan (t1 - t0), the look-back's wait (t2 - t1), the stores (t3 - t2),
how much later than a block's own aggregate the aggregate of the tile
before came out (t1[k-1] - t1[k]) and the latest of the seven tiles
before (the flagship's look-back reads up to seven), and the blocks a
SM.

Usage, from the repository root:
    python3 tools/back_end_timeline.py
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import dense_variants  # noqa: E402

TIMER = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"({}));'
EDITS = [
    ("fm_chain.cu", "  __syncthreads();\n  const int row = tid % kRows;",
     "  __syncthreads();\n  unsigned long long tl0, tl1, tl2, tl3;\n  "
     + TIMER.format("tl0") + "\n  const int row = tid % kRows;"),
    ("fm_chain.cu", "  const unsigned epoch = epoch_of(head_s);",
     "  const unsigned epoch = epoch_of(head_s);\n  " + TIMER.format("tl1")),
    ("fm_chain.cu",
     "  const float a_row = row > 0 ? ipow(a, row - 1) : 0.f;"
     "   // a^(j - j0)\n  __syncthreads();",
     "  const float a_row = row > 0 ? ipow(a, row - 1) : 0.f;\n"
     "  __syncthreads();\n  " + TIMER.format("tl2")),
    ("fm_chain.cu",
     "        if (tile == ntiles - 1) cz_out[c0 + c] = incl;\n"
     "      }\n    }\n  }\n}\n",
     "        if (tile == ntiles - 1) cz_out[c0 + c] = incl;\n"
     "      }\n    }\n  }\n  __syncthreads();\n"
     "  if (tid == 0 && M >= j0 + 6) {\n    " + TIMER.format("tl3") + "\n"
     "    unsigned sm;\n"
     '    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));\n'
     "    const unsigned long long t[4] = {tl0, tl1, tl2, tl3};\n"
     "    for (int q = 0; q < 4; ++q)\n"
     "      audio[j0 + q] = __uint_as_float((unsigned)t[q]);\n"
     "    audio[j0 + 4] = __uint_as_float((unsigned)(t[0] >> 32));\n"
     "    audio[j0 + 5] = __uint_as_float(sm);\n  }\n}\n"),
]


def measure():
    """In the timeline tree: each path's call, its device time and its
    blocks' timestamps, summarized."""
    import torch

    import chip_smoke as cs
    from gsdr_tpu_torch.tools.fm_rx import design_lowpass

    out = 255       # outputs a tile (fm_chain.cu kOut)
    paths = []
    for g in ("bf16x3", "f32"):
        m = cs.flagship("cuda", precision=g)
        paths.append((f"B1 flagship {g}", m, g,
                      cs.fm_signal(m, 0, cs.N, seed=11)))
    m = cs.FmChannelizer(
        sample_rate=cs.RX_FS, tuning_frequency=0.0,
        channel_frequencies=cs.RX_STATIONS, frequency_deviation=75e3,
        decimation=8, low_pass_taps=design_lowpass(129, 0.4 / 8),
        deemphasis_tau=75e-6, device="cuda")
    paths.append(("B1 fm_rx C=5, T=129, D=8 bf16x3", m, "bf16x3",
                  cs.fm_signal(m, 0, cs.N, seed=11)))
    for what, m, g, rf in paths:
        buf = cs.buffer(m, rf)
        n0, _, cf, cz = m.init()
        args = (buf, m.tap_bank, m.lo_table, n0, m.decimation, m.gain,
                m.deemph, cf, cz)
        dev = cs.device_us(lambda: cs.fm_chain(*args, precision=g), reps=20)
        audio = cs.fm_chain(*args, precision=g)[0]
        torch.cuda.synchronize()
        nt = audio.shape[1] // out
        w = (audio[0].view(torch.int32)[:nt * out].reshape(nt, out)[:, :6]
             .cpu().numpy().astype("int64") & 0xFFFFFFFF)
        t = [[(int(r[q]) | int(r[4]) << 32) for q in range(4)] for r in w]
        base = min(r[0] for r in t)
        t = [[v - base for v in r] for r in t]
        sm = [int(r[5]) for r in w]
        lag = [t[k - 1][1] - t[k][1] for k in range(1, nt)]
        lag7 = [max(t[k - d][1] for d in range(1, 8)) - t[k][1]
                for k in range(7, nt)]

        def stats(xs):
            xs = sorted(x / 1e3 for x in xs)
            return {"mean_us": statistics.fmean(xs),
                    "median_us": xs[len(xs) // 2],
                    "p90_us": xs[int(0.9 * (len(xs) - 1))],
                    "max_us": xs[-1]}

        print(json.dumps({
            "probe": "back_end_timeline", "kernel": what,
            "device_us": sum(dev.values()), "tiles": nt,
            "span_us": max(r[3] for r in t) / 1e3,
            "block_us": stats([r[3] - r[0] for r in t]),
            "scan_us": stats([r[1] - r[0] for r in t]),
            "wait_us": stats([r[2] - r[1] for r in t]),
            "store_us": stats([r[3] - r[2] for r in t]),
            "prev_aggregate_later_us": stats(lag),
            "prev_aggregate_later_share": sum(x > 0 for x in lag) / len(lag),
            "latest_of_7_later_us": stats(lag7),
            "blocks_per_sm_max": max(sm.count(s) for s in set(sm)),
            "card": cs.CARD}), flush=True)


def main():
    if sys.argv[1:] == ["--in-tree"]:
        import torch

        import chip_smoke as cs

        if not torch.cuda.is_available():
            return 1
        cs.CARD = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        measure()
        return 0
    tree = dense_variants.make_tree("timeline", EDITS)
    return subprocess.run([sys.executable, "tools/back_end_timeline.py",
                           "--in-tree"], cwd=tree).returncode


if __name__ == "__main__":
    sys.exit(main())
