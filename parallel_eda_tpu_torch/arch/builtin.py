"""Built-in architectures.

The benchmark config ladder (BASELINE.md) starts at ``k6_N10_40nm``; we ship a
built-in equivalent so the flow runs without an XML file.  Numbers are in the
ballpark of the VTR 40 nm models (not copied from any file in the reference
tree — the reference bundles no arch XMLs).
"""

from __future__ import annotations

from .model import (Arch, ColumnSpec, SegmentInf, SwitchInf, make_clb_type,
                    make_hard_type, make_io_type)


def k6_n10_arch() -> Arch:
    """K=6, N=10, I=33 soft-logic architecture, single wire type (length 1),
    buffered switches.  Stand-in for the k6_N10_40nm VTR arch."""
    arch = Arch(
        name="k6_N10",
        K=6, N=10, I=33, io_capacity=8,
        segments=[SegmentInf(name="l1", length=1, frequency=1.0,
                             Rmetal=101.0, Cmetal=22.5e-15,
                             wire_switch=0, opin_switch=1)],
        switches=[
            SwitchInf(name="wire_mux", buffered=True, R=551.0,
                      Cin=7.7e-15, Cout=12.9e-15, Tdel=58e-12),
            SwitchInf(name="opin_buf", buffered=True, R=551.0,
                      Cin=7.7e-15, Cout=12.9e-15, Tdel=75e-12),
        ],
        Fc_out=0.1, Fc_in=0.15,
        ipin_switch=0,
        default_chan_width=40,
    )
    arch.block_types = [
        make_io_type(index=0, capacity=arch.io_capacity),
        make_clb_type(index=1, K=arch.K, N=arch.N, I=arch.I,
                      T_comb=261e-12, T_setup=66e-12, T_clk_to_q=124e-12),
    ]
    return arch


def k6_n10_mem_arch(addr_bits: int = 6, data_bits: int = 8,
                    mem_start: int = 4, mem_repeat: int = 6) -> Arch:
    """k6_N10 plus a single-port RAM column type (Stratix-IV-style
    heterogeneous device: io ring, CLB interior, periodic 'bram' columns;
    physical_types.h t_type_descriptor + SetupGrid.c column fill).  The
    'spram' .subckt model maps onto it (pins: addr + data-in + we, then
    data-out, then clk)."""
    arch = k6_n10_arch()
    arch.name = "k6_N10_mem"
    num_in = addr_bits + data_bits + 1          # addr, din, we
    arch.block_types.append(make_hard_type(
        "bram", index=2, num_in=num_in, num_out=data_bits,
        T_comb=1.5e-9, T_setup=100e-12, T_clk_to_q=440e-12))
    arch.column_types = [ColumnSpec("bram", start=mem_start,
                                    repeat=mem_repeat)]
    arch.hard_models = {"spram": "bram"}
    return arch


def minimal_arch(K: int = 4, N: int = 2, I: int = 6,
                 io_capacity: int = 2, chan_width: int = 12) -> Arch:
    """Tiny architecture for tests: small CLBs so rr-graphs stay small."""
    arch = Arch(
        name="minimal",
        K=K, N=N, I=I, io_capacity=io_capacity,
        segments=[SegmentInf()],
        switches=[SwitchInf(), SwitchInf(name="opin_buf", Tdel=70e-12)],
        Fc_out=0.5, Fc_in=0.5,
        ipin_switch=0,
        default_chan_width=chan_width,
    )
    arch.block_types = [
        make_io_type(index=0, capacity=io_capacity),
        make_clb_type(index=1, K=K, N=N, I=I),
    ]
    return arch


def unidir_arch(K: int = 4, N: int = 2, I: int = 6,
                io_capacity: int = 2, chan_width: int = 12,
                length: int = 1) -> Arch:
    """Minimal arch with single-driver unidirectional wires (the modern
    VTR/Titan directionality, reference rr_graph.c:432-548
    UNI_DIRECTIONAL): even tracks run INC, odd DEC, wires are driven
    only at their start through the segment mux."""
    arch = minimal_arch(K=K, N=N, I=I, io_capacity=io_capacity,
                        chan_width=chan_width)
    arch.name = "minimal_unidir"
    arch.segments = [SegmentInf(name=f"l{length}", length=length,
                                directionality="unidir")]
    # unidir reaches fewer wires per pin position (starts only): keep
    # Fc generous so IO pads stay richly connected
    arch.Fc_out = 0.5
    arch.Fc_in = 0.5
    return arch
