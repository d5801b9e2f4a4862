"""BLEU scoring throughput: C++ core vs Python fallback vs Perl process."""

import os
import subprocess
import time

from lrcn_jax.evaluation import bleu as B

EVAL = "/root/reference/eval"


def main():
    stem = os.path.join(EVAL, "coco_refs", "ref")
    cand = os.path.join(EVAL, "candidates.txt")
    refs = B.load_reference_files(stem)
    hyps = [r.decode("utf-8", "surrogateescape")
            for r in open(cand, "rb").read().split(b"\n")[:-1]]

    t0 = time.perf_counter()
    native = B.multi_bleu(hyps, refs)
    t_native = time.perf_counter() - t0

    os.environ["LRCN_NATIVE"] = "0"
    t0 = time.perf_counter()
    python = B.multi_bleu(hyps, refs)
    t_py = time.perf_counter() - t0
    del os.environ["LRCN_NATIVE"]

    t0 = time.perf_counter()
    perl = subprocess.run(
        ["perl", os.path.join(EVAL, "multi-bleu.perl"), stem],
        stdin=open(cand, "rb"), capture_output=True, text=True)
    t_perl = time.perf_counter() - t0

    print(f"native: {t_native*1e3:.0f} ms   {native.format()}")
    print(f"python: {t_py*1e3:.0f} ms   {python.format()}")
    print(f"perl:   {t_perl*1e3:.0f} ms   {perl.stdout.strip()}")
    assert native.format() == python.format() == perl.stdout.strip()


if __name__ == "__main__":
    main()
