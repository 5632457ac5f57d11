"""Synthetic circuit generator.

The reference is benchmarked on MCNC/VTR/Titan BLIF circuits which are not
shipped in its tree; for self-contained tests and benchmarks we generate
random technology-mapped circuits with controllable size, fanin locality
(Rent-style: LUTs prefer recent producers) and register density, emitted as
ordinary :class:`LogicalNetlist` (round-trippable through BLIF).
"""

from __future__ import annotations

import random

from .netlist import (LogicalNetlist, Primitive,
                      PRIM_INPAD, PRIM_OUTPAD, PRIM_LUT, PRIM_FF)


def generate_circuit(num_luts: int = 100,
                     num_inputs: int = 8,
                     num_outputs: int = 8,
                     K: int = 6,
                     ff_ratio: float = 0.3,
                     locality: int = 40,
                     seed: int = 0,
                     name: str = "synth") -> LogicalNetlist:
    """Generate a random K-LUT circuit.

    ``locality`` is the window of most-recent signals a LUT draws inputs from;
    smaller windows yield more placeable (local) netlists, mimicking the
    locality real circuits get from synthesis.
    """
    rng = random.Random(seed)
    nl = LogicalNetlist(name=name)

    clock = "clk"
    nl.add(Primitive(name=clock, kind=PRIM_INPAD, output=clock))

    signals = []  # nets available as LUT inputs
    for i in range(num_inputs):
        n = f"pi{i}"
        nl.add(Primitive(name=n, kind=PRIM_INPAD, output=n))
        signals.append(n)

    for i in range(num_luts):
        window = signals[-locality:]
        fanin = rng.randint(2, min(K, len(window)))
        ins = rng.sample(window, fanin)
        out = f"n{i}"
        rows = [("".join(rng.choice("01-") for _ in range(fanin))) + " 1"
                for _ in range(rng.randint(1, 3))]
        nl.add(Primitive(name=out, kind=PRIM_LUT, inputs=ins, output=out,
                         truth_table=rows))
        if rng.random() < ff_ratio:
            q = f"q{i}"
            nl.add(Primitive(name=q, kind=PRIM_FF, inputs=[out], output=q,
                             clock=clock))
            signals.append(q)
        else:
            signals.append(out)

    # primary outputs tap the most recently produced signals
    for i in range(num_outputs):
        src = signals[-(i % min(len(signals), locality)) - 1]
        nl.add(Primitive(name=f"out:po{i}", kind=PRIM_OUTPAD, inputs=[src]))

    nl.finalize()
    return nl
