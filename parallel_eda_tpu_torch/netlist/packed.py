"""Packed (clustered) netlist model.

Equivalent of the reference's post-packing structures (``block``/``clb_net``
globals, vpr/SRC/base/vpr_types.h + read_netlist.c): blocks of a physical
type with pins mapped to inter-cluster nets.  Produced by the packer
(parallel_eda_tpu.pack) or read back from a .net file.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..arch.model import Arch, BlockType, PIN_CLASS_DRIVER


@dataclass(frozen=True)
class NetPin:
    block: int   # block index
    pin: int     # physical pin index on the block's type


@dataclass
class ClbNet:
    """Inter-cluster net.  Reference: ``t_net`` (clb_net[]) — driver is pin 0
    in VPR; here an explicit ``driver`` plus ``sinks`` list."""
    name: str
    driver: NetPin = None
    sinks: List[NetPin] = field(default_factory=list)
    is_global: bool = False   # clocks: not routed through the general fabric

    @property
    def num_sinks(self) -> int:
        return len(self.sinks)


@dataclass
class Block:
    """A packed cluster (CLB) or IO site occupant.

    ``pin_nets[p]`` is the net index on physical pin ``p`` (or -1).
    """
    name: str
    type_name: str
    pin_nets: List[int] = field(default_factory=list)
    prims: List[int] = field(default_factory=list)  # logical primitive indices


@dataclass
class PackedNetlist:
    name: str = "top"
    blocks: List[Block] = field(default_factory=list)
    nets: List[ClbNet] = field(default_factory=list)
    net_index: Dict[str, int] = field(default_factory=dict)

    def add_net(self, name: str, is_global: bool = False) -> int:
        if name in self.net_index:
            if is_global:
                self.nets[self.net_index[name]].is_global = True
            return self.net_index[name]
        self.nets.append(ClbNet(name=name, is_global=is_global))
        self.net_index[name] = len(self.nets) - 1
        return len(self.nets) - 1

    def connect(self) -> None:
        """Derive net driver/sink pin lists from block pin_nets."""
        for net in self.nets:
            net.driver = None
            net.sinks = []
        for bi, b in enumerate(self.blocks):
            bt = self._types[b.type_name]
            for p, ni in enumerate(b.pin_nets):
                if ni < 0:
                    continue
                cls = bt.pin_classes[bt.pin_class_of[p]]
                if cls.direction == PIN_CLASS_DRIVER:
                    if self.nets[ni].driver is not None:
                        raise ValueError(
                            f"net {self.nets[ni].name} multiply driven")
                    self.nets[ni].driver = NetPin(bi, p)
                else:
                    self.nets[ni].sinks.append(NetPin(bi, p))
        for net in self.nets:
            if net.driver is None:
                raise ValueError(f"net {net.name} undriven")

    def bind_types(self, arch: Arch) -> None:
        self._types = {t.name: t for t in arch.block_types}

    def block_type(self, bi: int) -> BlockType:
        return self._types[self.blocks[bi].type_name]

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    @property
    def routed_nets(self) -> List[int]:
        """Indices of nets the router must route (non-global, has sinks)."""
        return [i for i, n in enumerate(self.nets)
                if not n.is_global and n.sinks]

    def stats(self) -> str:
        by_type: Dict[str, int] = {}
        for b in self.blocks:
            by_type[b.type_name] = by_type.get(b.type_name, 0) + 1
        return (f"{self.name}: blocks {by_type}, {len(self.nets)} nets "
                f"({len(self.routed_nets)} routable)")
