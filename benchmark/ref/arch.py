"""Frozen copy of the port's ``arch/model.py`` (architecture model, and
k6_n10_arch of arch/builtin.py), kept with the benchmark as part of its
yardstick: the reference rebuilds from it what the program derives, and
compares. Only imports were changed."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# Pin class directions (reference: libarchfpga physical_types.h e_pin_type)
PIN_CLASS_RECEIVER = 0  # input pins
PIN_CLASS_DRIVER = 1    # output pins


@dataclass
class SegmentInf:
    """A routing wire segment type.

    Reference: ``t_segment_inf`` (libarchfpga/include/physical_types.h),
    consumed by build_rr_graph (vpr/SRC/route/rr_graph.c:385).
    """
    name: str = "l1"
    length: int = 1            # logic blocks spanned per wire
    frequency: float = 1.0     # fraction of channel tracks of this type
    Rmetal: float = 100.0      # ohms per logic-block length
    Cmetal: float = 20e-15     # farads per logic-block length
    # index of the switch used between wires of this segment type
    wire_switch: int = 0
    opin_switch: int = 0
    # "bidir" (VPR4-style bidirectional wires, tri-state switches) or
    # "unidir" (single-driver directed wires, mux switches — every modern
    # VTR/Titan arch; reference rr_graph.c:432-548 UNI_DIRECTIONAL).
    # The rr-graph construction requires all segments to agree.
    directionality: str = "bidir"


@dataclass
class SwitchInf:
    """A routing switch (mux/buffer/pass transistor).

    Reference: ``t_switch_inf`` (libarchfpga/include/physical_types.h);
    used by the router's delay model (route/route_timing.c:663-672).
    """
    name: str = "mux0"
    buffered: bool = True
    R: float = 500.0
    Cin: float = 5e-15
    Cout: float = 5e-15
    Tdel: float = 50e-12


@dataclass
class PinClass:
    """An equivalence class of physical pins on a block type.

    Reference: ``t_class`` (libarchfpga).  All pins in a class are logically
    equivalent; SOURCE/SINK rr-nodes are created per class with
    capacity == len(pins) (rr_graph.c alloc_and_load_rr_graph).
    """
    direction: int                 # PIN_CLASS_DRIVER or PIN_CLASS_RECEIVER
    pins: List[int] = field(default_factory=list)
    is_clock: bool = False


@dataclass
class BlockType:
    """A placeable physical block type (CLB, IO, ...).

    Reference: ``t_type_descriptor`` (libarchfpga/include/physical_types.h).
    """
    name: str
    index: int
    num_pins: int
    capacity: int = 1               # placement sites per grid tile (IO > 1)
    pin_classes: List[PinClass] = field(default_factory=list)
    # pin -> class index
    pin_class_of: List[int] = field(default_factory=list)
    # pin -> side assignment handled uniformly by the rr-graph construction (all pins
    # accessible from all adjacent channels; VPR7's default pin_location
    # "spread" is approximated as omni-side access).
    is_io: bool = False
    # Combinational delay through the block (input pin -> output pin), and
    # sequential setup/clk-to-q.  Stand-ins for VPR7's <pb_type> delay matrix.
    T_comb: float = 400e-12
    T_setup: float = 60e-12
    T_clk_to_q: float = 80e-12

    @property
    def num_input_pins(self) -> int:
        return sum(len(c.pins) for c in self.pin_classes
                   if c.direction == PIN_CLASS_RECEIVER and not c.is_clock)

    @property
    def num_output_pins(self) -> int:
        return sum(len(c.pins) for c in self.pin_classes
                   if c.direction == PIN_CLASS_DRIVER)


@dataclass
class DirectSpec:
    """Dedicated inter-block connection (``t_direct_inf``,
    libarchfpga physical_types.h; Process_Directs in
    read_xml_arch_file.c): OPIN ``from_pin`` of a ``from_type`` block at
    (x, y) drives IPIN ``to_pin`` of the ``to_type`` block at
    (x+dx, y+dy) through a dedicated wire that bypasses the general
    routing fabric — carry chains, register shift chains."""
    from_type: str
    from_pin: int
    to_type: str
    to_pin: int
    dx: int = 0
    dy: int = 1
    switch: int = -1            # -1 = delayless


@dataclass
class ColumnSpec:
    """Periodic column assignment of a heterogeneous block type
    (Stratix-IV-style RAM/DSP columns).

    Reference: grid column assignment in vpr/SRC/base/SetupGrid.c
    (t_grid_loc_def col semantics): interior columns x with
    ``(x - start) % repeat == 0`` hold ``type_name`` blocks instead of
    CLBs."""
    type_name: str
    start: int = 4
    repeat: int = 8


@dataclass
class Arch:
    """Full device architecture.

    Reference: ``t_arch`` built by XmlReadArch
    (libarchfpga/read_xml_arch_file.c:2528).
    """
    name: str = "arch"
    # logic cluster shape (AAPack target): N BLEs of K-LUT+FF each, I inputs
    K: int = 6
    N: int = 10
    I: int = 33
    io_capacity: int = 8
    block_types: List[BlockType] = field(default_factory=list)
    # heterogeneous column assignments (empty = homogeneous CLB interior)
    column_types: List[ColumnSpec] = field(default_factory=list)
    # dedicated inter-block connections (<directlist>, Process_Directs)
    directs: List[DirectSpec] = field(default_factory=list)
    # hard-block models (.subckt name -> block type name), read_blif.c
    # model lookup equivalent
    hard_models: Dict[str, str] = field(default_factory=dict)
    segments: List[SegmentInf] = field(default_factory=list)
    switches: List[SwitchInf] = field(default_factory=list)
    # fraction of channel tracks each OPIN / IPIN connects to; if the arch
    # XML gave absolute track counts ("abs" fc type), they are kept in
    # Fc_*_abs and win over the fractions once the real channel width is
    # known (rr-graph construction), Process_Fc read_xml_arch_file.c semantics
    Fc_out: float = 0.25
    Fc_in: float = 0.15
    Fc_out_abs: Optional[int] = None
    Fc_in_abs: Optional[int] = None

    # per-pin Fc overrides: (block type name, pin index) -> fraction /
    # absolute track count (read_xml_arch_file.c Process_Fc
    # <fc_override> semantics; win over the arch-wide default)
    Fc_pin: Dict[Tuple[str, int], float] = field(default_factory=dict)
    Fc_pin_abs: Dict[Tuple[str, int], int] = field(default_factory=dict)

    def fc_frac(self, chan_width: int, is_out: bool,
                type_name: Optional[str] = None,
                pin: Optional[int] = None) -> float:
        if type_name is not None and pin is not None:
            ab = self.Fc_pin_abs.get((type_name, pin))
            if ab is not None:
                return min(1.0, ab / max(1, chan_width))
            ov = self.Fc_pin.get((type_name, pin))
            if ov is not None:
                return min(1.0, ov)
        ab = self.Fc_out_abs if is_out else self.Fc_in_abs
        if ab is not None:
            return min(1.0, ab / max(1, chan_width))
        return self.Fc_out if is_out else self.Fc_in
    # IPIN mux delay (switch index used wire->IPIN)
    ipin_switch: int = 0
    # routing channel default width (overridden by --route_chan_width)
    default_chan_width: int = 24
    # intra-cluster crossbar population: 1.0 = full crossbar (every
    # cluster input/feedback reaches every BLE input pin — packing is
    # trivially routable and the packer skips the check); < 1.0 = sparse
    # crossbar with that fraction of the switch points populated on a
    # deterministic staggered pattern, and the packer must verify each
    # cluster is intra-routable (pack/cluster_legality.c semantics)
    xbar_density: float = 1.0
    # multi-mode cluster pb_type tree (pack/pb_type.py PbType;
    # read_xml_arch_file.c:2528 ProcessPb_Type).  When set, the packer
    # assigns molecules to leaves with per-slot mode choices and
    # verifies legality by detail-routing the cluster interconnect
    # (cluster_legality.c semantics) instead of the flat-crossbar model.
    # The flat K/N/I fields stay authoritative for the rr-graph's
    # physical pin counts — keep them consistent with the tree's ports.
    pb_tree: Optional[object] = None
    # switch-block pattern (<switch_block type= fs=>, ProcessSwitchblocks).
    # The rr-graph construction implements ONE pattern co-designed with the planes
    # kernel's roll stencils: subset continuations/turns + parity-rotated
    # mixing turns (Fs=3-class, the Wilton index-permutation property —
    # rr/graph.py "switch-box edges").  The parser records what the XML
    # asked for; the construction warns when it differs.
    sb_type: str = "subset_rotated"
    sb_fs: int = 3

    def block_type(self, name: str) -> BlockType:
        for t in self.block_types:
            if t.name == name:
                return t
        raise KeyError(name)

    @property
    def io_type(self) -> BlockType:
        return next(t for t in self.block_types if t.is_io)

    @property
    def clb_type(self) -> BlockType:
        return next(t for t in self.block_types if not t.is_io)


def make_clb_type(index: int, K: int, N: int, I: int,
                  T_comb: float = 400e-12,
                  T_setup: float = 60e-12,
                  T_clk_to_q: float = 80e-12) -> BlockType:
    """Build a CLB block type: I input pins (one class), N output pins (one
    class), 1 clock pin.  Mirrors the k6_N10 soft logic cluster."""
    num_pins = I + N + 1
    pin_classes = [
        PinClass(PIN_CLASS_RECEIVER, list(range(0, I))),
        PinClass(PIN_CLASS_DRIVER, list(range(I, I + N))),
        PinClass(PIN_CLASS_RECEIVER, [I + N], is_clock=True),
    ]
    pin_class_of = [0] * I + [1] * N + [2]
    return BlockType(
        name="clb", index=index, num_pins=num_pins, capacity=1,
        pin_classes=pin_classes, pin_class_of=pin_class_of, is_io=False,
        T_comb=T_comb, T_setup=T_setup, T_clk_to_q=T_clk_to_q,
    )


def make_hard_type(name: str, index: int, num_in: int, num_out: int,
                   T_comb: float = 1.5e-9, T_setup: float = 100e-12,
                   T_clk_to_q: float = 400e-12) -> BlockType:
    """A hard block type (RAM / DSP column block): num_in data+address
    input pins (one class), num_out output pins (one class), one clock.
    Stratix-IV-style heterogeneous tile (physical_types.h
    t_type_descriptor with its own pin classes and timing)."""
    num_pins = num_in + num_out + 1
    pin_classes = [
        PinClass(PIN_CLASS_RECEIVER, list(range(0, num_in))),
        PinClass(PIN_CLASS_DRIVER, list(range(num_in, num_in + num_out))),
        PinClass(PIN_CLASS_RECEIVER, [num_in + num_out], is_clock=True),
    ]
    pin_class_of = [0] * num_in + [1] * num_out + [2]
    return BlockType(
        name=name, index=index, num_pins=num_pins, capacity=1,
        pin_classes=pin_classes, pin_class_of=pin_class_of, is_io=False,
        T_comb=T_comb, T_setup=T_setup, T_clk_to_q=T_clk_to_q,
    )


def make_io_type(index: int, capacity: int) -> BlockType:
    """IO block: one input pad pin (class 0, receiver — for outpads) and one
    output pad pin (class 1, driver — for inpads), per site."""
    pin_classes = [
        PinClass(PIN_CLASS_RECEIVER, [0]),
        PinClass(PIN_CLASS_DRIVER, [1]),
    ]
    return BlockType(
        name="io", index=index, num_pins=2, capacity=capacity,
        pin_classes=pin_classes, pin_class_of=[0, 1], is_io=True,
        T_comb=0.0, T_setup=0.0, T_clk_to_q=0.0,
    )


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
