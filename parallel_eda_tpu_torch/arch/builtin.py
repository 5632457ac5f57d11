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


_FRAC_PB_XML = """
<pb_type name="clb">
  <input name="I" num_pins="{I}"/>
  <output name="O" num_pins="{O}"/>
  <clock name="clk" num_pins="1"/>
  <pb_type name="ble" num_pb="{N}">
    <input name="in" num_pins="10"/>
    <output name="out" num_pins="2"/>
    <clock name="clk" num_pins="1"/>
    <mode name="lut6">
      <pb_type name="lut6" blif_model=".names" num_pb="1">
        <input name="in" num_pins="6"/><output name="out" num_pins="1"/>
      </pb_type>
      <pb_type name="ff" blif_model=".latch" num_pb="1">
        <input name="D" num_pins="1"/><output name="Q" num_pins="1"/>
        <clock name="clk" num_pins="1"/>
      </pb_type>
      <interconnect>
        <direct name="d_in" input="ble.in[5:0]" output="lut6.in"/>
        <mux name="m_d" input="lut6.out ble.in[6]" output="ff.D"/>
        <mux name="m_o" input="lut6.out ff.Q" output="ble.out[0]"/>
        <direct name="d_c" input="ble.clk" output="ff.clk"/>
      </interconnect>
    </mode>
    <mode name="lut5x2">
      <pb_type name="lut5" blif_model=".names" num_pb="2">
        <input name="in" num_pins="5"/><output name="out" num_pins="1"/>
      </pb_type>
      <pb_type name="ff" blif_model=".latch" num_pb="2">
        <input name="D" num_pins="1"/><output name="Q" num_pins="1"/>
        <clock name="clk" num_pins="1"/>
      </pb_type>
      <interconnect>
        <direct name="d0" input="ble.in[4:0]" output="lut5[0].in"/>
        <direct name="d1" input="ble.in[9:5]" output="lut5[1].in"/>
        <mux name="m0" input="lut5[0].out ble.in[0]" output="ff[0].D"/>
        <mux name="m1" input="lut5[1].out ble.in[5]" output="ff[1].D"/>
        <mux name="o0" input="lut5[0].out ff[0].Q" output="ble.out[0]"/>
        <mux name="o1" input="lut5[1].out ff[1].Q" output="ble.out[1]"/>
        <complete name="dc" input="ble.clk" output="ff[0:1].clk"/>
      </interconnect>
    </mode>
  </pb_type>
  <interconnect>
    <complete name="xbar" input="clb.I ble[0:{NM1}].out" output="ble[0:{NM1}].in"/>
    <direct name="outs" input="ble[0:{NM1}].out" output="clb.O"/>
    <complete name="clks" input="clb.clk" output="ble[0:{NM1}].clk"/>
  </interconnect>
</pb_type>
"""


def frac_arch(N: int = 4, I: int = 20, chan_width: int = 14) -> Arch:
    """Fracturable-LUT multi-mode architecture: each of the N BLE slots
    runs as one 6-LUT (mode lut6) or two independent 5-LUTs (mode
    lut5x2), k6_frac-style.  The pb tree drives packing (mode choice +
    cluster_legality.c-style detail routing, pack/pb_pack.py); the flat
    K/N/I view drives the rr graph: I cluster inputs, 2N output pins
    (two per slot), K=6 for BLIF reading."""
    import xml.etree.ElementTree as ET

    from ..pack.pb_type import parse_pb_type

    arch = minimal_arch(K=6, N=2 * N, I=I, chan_width=chan_width)
    arch.name = f"frac_N{N}"
    xml = _FRAC_PB_XML.format(I=I, O=2 * N, N=N, NM1=N - 1)
    arch.pb_tree = parse_pb_type(ET.fromstring(xml))
    return arch
