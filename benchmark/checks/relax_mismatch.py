"""relax_mismatch: cells where the relaxation calls captured in the window
(K1, K2) differ from the reference relaxation on the same inputs, plus
one per kind with no call captured, plus, on the card, each launch of
the kinds' kernels in the window that the captured calls' spy did not
see. An exact comparison: LIMIT 0."""

from ref import judge

LIMIT = 0


def read(ref) -> int:
    spy = ref.run.spy
    return int(judge.relax_mismatch(ref.rr, spy.captured, spy.calls,
                                    spy.launched, ref.run.device))
