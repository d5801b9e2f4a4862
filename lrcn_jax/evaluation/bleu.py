"""Multi-BLEU scorer matching the reference's modified Moses script.

Re-implements ``eval/multi-bleu.perl`` from the reference repo semantically
exactly — including its deliberate modification: the brevity penalty is
DISABLED (the BP computation is commented out at eval/multi-bleu.perl:137-144
and BP is pinned to 1 at line 118), so scores are inflated vs. standard BLEU.
All parity claims against the reference's committed eval artifacts must use
these semantics (see BASELINE.md).

Semantics reproduced:
- cumulative BLEU-1..4 from clipped n-gram counts (multi-bleu.perl:65-115);
- per-sentence closest-reference-length bookkeeping, ties broken toward the
  shorter reference (multi-bleu.perl:50-64) — still computed because the
  ratio/hyp_len/ref_len are printed;
- ``my_log(0) = -9999999999`` (multi-bleu.perl:170-173);
- tokens are whitespace-split with leading/trailing whitespace ignored
  (Perl ``split ' '``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections import Counter
from typing import Sequence

_MY_LOG_ZERO = -9999999999.0


def _my_log(x: float) -> float:
    # multi-bleu.perl:170-173 — Perl `unless $_[0]` is false for 0.
    return _MY_LOG_ZERO if not x else math.log(x)


def _ngrams(words: Sequence[str], n: int) -> Counter:
    return Counter(tuple(words[i:i + n]) for i in range(len(words) - n + 1))


@dataclasses.dataclass(frozen=True)
class BleuResult:
    bleu: tuple[float, float, float, float]  # cumulative BLEU-1..4 in [0,1]
    brevity_penalty: float
    ratio: float
    hyp_len: int
    ref_len: int

    def format(self) -> str:
        """Exact output line of multi-bleu.perl:160-168."""
        b = self.bleu
        return ("BLEU = %.1f/%.1f/%.1f/%.1f "
                "(BP=%.3f, ratio=%.3f, hyp_len=%d, ref_len=%d)" % (
                    100 * b[0], 100 * b[1], 100 * b[2], 100 * b[3],
                    self.brevity_penalty, self.ratio,
                    self.hyp_len, self.ref_len))


def _counts_native(hypotheses, references, lowercase):
    """Accumulate BLEU statistics in the C++ core (native/bleu.cpp).

    Returns (correct, total, hyp_len, ref_len) like the Python loop, or
    None if the native library is unavailable.  Lowercasing happens here in
    Python (Unicode-correct) so the byte-level core sees final text.
    """
    import ctypes

    from lrcn_jax.native import bleu_library

    lib = bleu_library()
    if lib is None:
        return None
    enc = lambda s: s.encode("utf-8", errors="surrogateescape")
    stats = lib.lrcn_bleu_stats_new()
    try:
        for s, hyp in enumerate(hypotheses):
            refs = references[s] if s < len(references) else []
            if lowercase:
                hyp = hyp.lower()
                refs = [r.lower() for r in refs]
            ref_arr = (ctypes.c_char_p * len(refs))(*map(enc, refs))
            lib.lrcn_bleu_accumulate(stats, enc(hyp), ref_arr,
                                     len(refs), 0)
        out = (ctypes.c_longlong * 10)()
        lib.lrcn_bleu_get(stats, out)
    finally:
        lib.lrcn_bleu_stats_free(stats)
    correct = [0] + list(out[0:4])
    total = [0] + list(out[4:8])
    return correct, total, int(out[8]), int(out[9])


def multi_bleu(hypotheses: Sequence[str],
               references: Sequence[Sequence[str]],
               lowercase: bool = False) -> BleuResult:
    """Score hypothesis lines against per-sentence reference lists.

    ``references[s]`` is the list of reference strings for hypothesis ``s``.
    Uses the C++ statistics core when available (LRCN_NATIVE=0 disables);
    the Python loop below is the reference implementation and fallback.
    """
    native = _counts_native(hypotheses, references, lowercase)
    if native is not None:
        return _finalize(*native)

    correct = [0] * 5   # 1-indexed by n
    total = [0] * 5
    length_translation = 0
    length_reference = 0

    for s, hyp in enumerate(hypotheses):
        if lowercase:
            hyp = hyp.lower()
        hyp_words = hyp.split()
        refs = references[s] if s < len(references) else []

        # Clipped reference n-gram counts: max over references
        # (multi-bleu.perl:65-81).
        ref_ngram: dict[tuple, int] = {}
        closest_diff, closest_length = 9999, 9999
        for ref in refs:
            if lowercase:
                ref = ref.lower()
            ref_words = ref.split()
            diff = abs(len(hyp_words) - len(ref_words))
            if diff < closest_diff:
                closest_diff, closest_length = diff, len(ref_words)
            elif diff == closest_diff:
                closest_length = min(closest_length, len(ref_words))
            for n in range(1, 5):
                for ngram, c in _ngrams(ref_words, n).items():
                    key = (n,) + ngram
                    if ref_ngram.get(key, 0) < c:
                        ref_ngram[key] = c

        length_translation += len(hyp_words)
        length_reference += closest_length

        for n in range(1, 5):
            for ngram, c in _ngrams(hyp_words, n).items():
                key = (n,) + ngram
                total[n] += c
                r = ref_ngram.get(key)
                if r is not None:
                    correct[n] += c if r >= c else r

    return _finalize(correct, total, length_translation, length_reference)


def _finalize(correct, total, length_translation, length_reference
              ) -> BleuResult:
    if length_reference == 0:
        return BleuResult((0.0, 0.0, 0.0, 0.0), 0.0, 0.0, 0, 0)

    precisions = [0.0] * 5
    for n in range(1, 5):
        precisions[n] = (correct[n] / total[n]) if total[n] else 0.0

    brevity_penalty = 1.0  # BP disabled (multi-bleu.perl:118,137-139)

    logs = [_my_log(precisions[n]) for n in range(1, 5)]
    cumulative = tuple(
        brevity_penalty * math.exp(sum(logs[:k]) / k) for k in range(1, 5)
    )
    return BleuResult(
        bleu=cumulative,
        brevity_penalty=brevity_penalty,
        ratio=length_translation / length_reference,
        hyp_len=length_translation,
        ref_len=length_reference,
    )


def load_reference_files(stem: str) -> list[list[str]]:
    """Load reference files ``stem0``, ``stem1``, ... plus bare ``stem``.

    Mirrors multi-bleu.perl:19-28: numbered files first, then the bare stem
    if it exists; also the ``.ref`` fallback.
    """
    if (not os.path.exists(stem) and not os.path.exists(stem + "0")
            and os.path.exists(stem + ".ref0")):
        stem = stem + ".ref"
    per_sentence: list[list[str]] = []

    def add_file(path: str) -> None:
        with open(path, "rb") as f:
            for s, raw in enumerate(f.read().split(b"\n")[:-1]):
                line = raw.decode("utf-8", errors="surrogateescape")
                while len(per_sentence) <= s:
                    per_sentence.append([])
                per_sentence[s].append(line)

    ref = 0
    found = False
    while os.path.exists(f"{stem}{ref}"):
        add_file(f"{stem}{ref}")
        found = True
        ref += 1
    if os.path.exists(stem):
        add_file(stem)
        found = True
    if not found:
        raise FileNotFoundError(f"could not find reference file {stem}")
    return per_sentence


def multi_bleu_files(ref_stem: str, hypothesis_path: str,
                     lowercase: bool = False) -> BleuResult:
    """File-based entry point: ``multi-bleu.perl ref_stem < hypotheses``."""
    references = load_reference_files(ref_stem)
    with open(hypothesis_path, "rb") as f:
        hyps = [raw.decode("utf-8", errors="surrogateescape")
                for raw in f.read().split(b"\n")[:-1]]
    return multi_bleu(hyps, references, lowercase=lowercase)


def main(argv: Sequence[str] | None = None) -> int:
    """CLI mirroring ``perl multi-bleu.perl [-lc] ref_stem < hyps``."""
    import sys
    args = list(sys.argv[1:] if argv is None else argv)
    lowercase = False
    if args and args[0] == "-lc":
        lowercase = True
        args.pop(0)
    if not args:
        print("usage: python -m lrcn_jax.evaluation.bleu [-lc] reference "
              "< hypothesis", file=sys.stderr)
        return 1
    try:
        references = load_reference_files(args[0])
    except FileNotFoundError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    hyps = [ln.rstrip("\n") for ln in sys.stdin]
    result = multi_bleu(hyps, references, lowercase=lowercase)
    print(result.format())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
