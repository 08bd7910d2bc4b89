"""Time design variants of the bf16 chunked dense front
(csrc/fronts.cuh, toeplitz_front_mma_chunked) on one NVIDIA GPU, against
this checkout, in one process tree each, in turns.

A variant is a copy of this checkout's package, chip_smoke.py and tools/
under build/variants/<name> with one edit to the CUDA sources (VARIANTS
below; an edit whose text is not found fails the run). Every tree's
libraries are built first, all at once; then each round runs
`tools/probe_grades.py dense_mma` in this checkout and in each variant's
tree, in that order, and prints its JSON lines with a "variant" key
("checkout" for this one). Equal digests across trees say a variant's
outputs are bit-equal to the checkout's.

Usage, from the repository root:
    python3 tools/dense_variants.py [--rounds N] [variant ...]
(no variant: all of them).
"""

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = "gsdr_tpu_torch/kernels/csrc"
FM_BLOCK = "return gsdr::mma_chunk_block(C, M, kCG, kTile, kTile - kOut);"

# name: [(source under csrc/, text, replacement)]
VARIANTS = {
    # the FM chain's chunked blocks keep 16 channels (no narrowing)
    "fm16": [("fm_chain.cu", FM_BLOCK,
              "return gsdr::mma_chunk_block(C, 0, kCG, kTile, kTile - kOut);")],
    # ... or narrow to 8 channels at most
    "fm8": [("fm_chain.cu", FM_BLOCK,
             "gsdr::MmaBlock b = gsdr::mma_chunk_block(C, M, kCG, kTile, "
             "kTile - kOut);\n  if (b.ch < 8 && C > 4) b.ch = 8;\n  return b;")],
    # the AM chain's chunked blocks keep 128 rows at least
    "am128": [("am_chain.cu",
               "return gsdr::mma_chunk_block(C, M, kCG, gsdr::kMmaMinRows, 0);",
               "return gsdr::mma_chunk_block(C, M, kCG, 128, 0);")],
    # a ring of three staging buffers
    "ring3": [("fronts.cuh", "constexpr int kMmaStages = 2;",
               "constexpr int kMmaStages = 3;")],
    # the product's loop over blocks of 8 taps not unrolled, or unrolled
    # by 2 at every block width
    "unroll1": [("fronts.cuh", "constexpr int kUnroll = kNT == 4 ? 1 : 2;",
                 "constexpr int kUnroll = 1;")],
    "unroll2": [("fronts.cuh", "constexpr int kUnroll = kNT == 4 ? 1 : 2;",
                 "constexpr int kUnroll = 2;")],
}


def make_tree(name, edits):
    """build/variants/<name>: this checkout's package, chip_smoke.py and
    tools/, with the variant's edits [(source under csrc/, text,
    replacement)]."""
    dst = ROOT / "build" / "variants" / name
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copytree(ROOT / "gsdr_tpu_torch", dst / "gsdr_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(ROOT / "tools", dst / "tools",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    for source, text, replacement in edits:
        path = dst / CSRC / source
        src = path.read_text()
        if text not in src:
            raise SystemExit(f"variant {name}: text not found in {source}")
        path.write_text(src.replace(text, replacement))
    return dst


def main(variants=VARIANTS, probe="dense_mma", doc=__doc__):
    """Runs `tools/probe_grades.py <probe>` in this checkout and in each
    named variant's tree (all of ``variants`` where none is named), in
    turns."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("variants", nargs="*", help=", ".join(variants))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    names = args.variants or list(variants)
    unknown = set(names) - set(variants)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    trees = [("checkout", ROOT)] + [(n, make_tree(n, variants[n]))
                                    for n in names]
    build = ("from gsdr_tpu_torch.kernels import _build; "
             "_build.build_all(['fm_chain', 'am_chain', 'channelize'])")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=tree)
             for _, tree in trees]
    if any([p.wait() != 0 for p in procs]):
        raise SystemExit("a tree's kernels did not build")
    for r in range(args.rounds):
        for name, tree in trees:
            out = subprocess.run(
                [sys.executable, "tools/probe_grades.py", probe],
                cwd=tree, capture_output=True, text=True, timeout=900)
            if out.returncode != 0:   # say so and go on with the others
                print(json.dumps({"variant": name, "run": r,
                                  "error": out.stderr[-2000:]}), flush=True)
                continue
            for line in out.stdout.splitlines():
                if line.startswith("{"):
                    rec = json.loads(line)
                    rec.update(variant=name, run=r)
                    print(json.dumps(rec), flush=True)
                else:
                    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
