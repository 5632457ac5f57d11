"""VPR7-style architecture XML reader (subset).

Equivalent of ``XmlReadArch`` (reference:
libarchfpga/read_xml_arch_file.c:2528, via the bundled ezxml parser).  We use
the stdlib ElementTree and accept the subset of the VPR7 schema needed for the
BASELINE.md ladder: <switchlist>, <segmentlist>, <complexblocklist> with an
``io`` pb_type and one cluster pb_type, and <device><fc>.

Anything unrecognised is ignored with a warning rather than rejected, so real
VTR arch files load with approximated semantics (fracturable LUT modes etc.
collapse to the K/N/I cluster summary, which is all the packer/placer/router
layers consume).
"""

from __future__ import annotations

import warnings
import xml.etree.ElementTree as ET
from typing import Optional

import re

from .model import (Arch, ColumnSpec, DirectSpec, SegmentInf, SwitchInf,
                    make_clb_type, make_hard_type, make_io_type)


def _f(attrib: dict, key: str, default: float) -> float:
    try:
        return float(attrib.get(key, default))
    except (TypeError, ValueError):
        return default


def read_arch_xml(path: str) -> Arch:
    tree = ET.parse(path)
    root = tree.getroot()
    if root.tag != "architecture":
        raise ValueError(f"{path}: root element is <{root.tag}>, "
                         "expected <architecture>")

    arch = Arch(name=path)

    # --- switches (ref: ProcessSwitches, read_xml_arch_file.c) ---
    switches = []
    sl = root.find("switchlist")
    if sl is not None:
        for sw in sl.findall("switch"):
            a = sw.attrib
            switches.append(SwitchInf(
                name=a.get("name", f"sw{len(switches)}"),
                buffered=a.get("type", "mux") in ("mux", "buffer"),
                R=_f(a, "R", 500.0),
                Cin=_f(a, "Cin", 5e-15),
                Cout=_f(a, "Cout", 5e-15),
                Tdel=_f(a, "Tdel", 50e-12),
            ))
    if not switches:
        switches = [SwitchInf()]
    arch.switches = switches

    def _switch_index(name: Optional[str]) -> int:
        for i, s in enumerate(arch.switches):
            if s.name == name:
                return i
        return 0

    # --- segments (ref: ProcessSegments) ---
    segments = []
    segl = root.find("segmentlist")
    if segl is not None:
        for seg in segl.findall("segment"):
            a = seg.attrib
            mux = seg.find("mux")
            wire_switch = _switch_index(mux.attrib.get("name")) if mux is not None else 0
            # VTR schema: type="unidir" (single-driver, <mux>) vs
            # type="bidir" (<wire_switch>/<opin_switch> children);
            # a bare <mux> child also implies unidir
            # (read_xml_arch_file.c ProcessSegments UNI_DIRECTIONAL)
            dir_attr = a.get("type", "").lower()
            if dir_attr not in ("unidir", "bidir"):
                dir_attr = "unidir" if mux is not None else "bidir"
            segments.append(SegmentInf(
                name=a.get("name", f"seg{len(segments)}"),
                length=int(float(a.get("length", 1))),
                frequency=_f(a, "freq", 1.0),
                Rmetal=_f(a, "Rmetal", 100.0),
                Cmetal=_f(a, "Cmetal", 20e-15),
                wire_switch=wire_switch,
                opin_switch=wire_switch,
                directionality=dir_attr,
            ))
    if not segments:
        segments = [SegmentInf()]
    arch.segments = segments

    def _read_fc(scope) -> bool:
        """Apply the first <fc> under ``scope``; VPR7 puts <fc> inside each
        pb_type (default_*_val attrs), VPR8 under <device> (in/out_val).
        An "abs" fc type means an absolute track count — stored separately
        (Arch.Fc_*_abs) and converted to a fraction by the rr builder once
        the real channel width is known (read_xml_arch_file.c Process_Fc
        semantics)."""
        for fc in scope.iter("fc"):
            a = fc.attrib
            if "default_in_val" in a:
                in_val = _f(a, "default_in_val", arch.Fc_in)
                out_val = _f(a, "default_out_val", arch.Fc_out)
                in_type = a.get("default_in_type", "frac").lower()
                out_type = a.get("default_out_type", "frac").lower()
            else:
                in_val = _f(a, "in_val", arch.Fc_in)
                out_val = _f(a, "out_val", arch.Fc_out)
                in_type = a.get("in_type", "frac").lower()
                out_type = a.get("out_type", "frac").lower()
            if in_type == "abs":
                arch.Fc_in_abs = int(round(in_val))
            else:
                arch.Fc_in = min(1.0, in_val)
            if out_type == "abs":
                arch.Fc_out_abs = int(round(out_val))
            else:
                arch.Fc_out = min(1.0, out_val)
            return True
        return False

    # --- complex blocks: extract io capacity + cluster K/N/I summary;
    # later top-level pb_types (memory, mult, ...) become heterogeneous
    # hard block types with column assignments (t_type_descriptor +
    # SetupGrid.c col fill) ---
    io_capacity = 8
    K, N, I = 6, 10, 33
    cluster_pb = None
    hard_pbs = []
    cbl = root.find("complexblocklist")
    if cbl is not None:
        for pb in cbl.findall("pb_type"):
            name = pb.attrib.get("name", "")
            if name in ("io", "inpad", "outpad"):
                io_capacity = int(float(pb.attrib.get("capacity", io_capacity)))
                continue
            # the first non-io top-level pb_type is the logic cluster; later
            # ones (memory, mult, ...) don't override its geometry
            if cluster_pb is None:
                cluster_pb = pb
            else:
                hard_pbs.append(pb)

        # per-type (port name -> (first pin index, width)) maps so
        # <direct> / fc overrides can resolve "type.port[k]" pin names:
        # inputs take indices 0.., outputs follow (the make_*_type pin
        # numbering)
        port_ranges: dict = {}
        for pb in ([cluster_pb] if cluster_pb is not None else []) \
                + hard_pbs:
            tname = pb.attrib.get("name", "")
            ranges = {}
            off = 0
            for e in pb.findall("input"):
                w = int(float(e.attrib.get("num_pins", 0)))
                ranges[e.attrib.get("name", "")] = (off, w)
                off += w
            for e in pb.findall("output"):
                w = int(float(e.attrib.get("num_pins", 0)))
                ranges[e.attrib.get("name", "")] = (off, w)
                off += w
            port_ranges[tname] = ranges

        # the built cluster BlockType is always named "clb"
        # (make_clb_type); XML names like "lab" must map onto it for
        # directs / fc overrides to land on the built type
        cluster_xml_name = (cluster_pb.attrib.get("name", "clb")
                            if cluster_pb is not None else "clb")

        def _built_name(t: str) -> str:
            return "clb" if t == cluster_xml_name else t

        def _pin_index(ref: str):
            """'type.port[k]', 'type.port[hi:lo]' or 'type.port' ->
            (built type name, first pin index, bit count)."""
            m = re.fullmatch(
                r"(\w+)\.(\w+)(?:\[(\d+)(?::(\d+))?\])?", ref.strip())
            if not m:
                return None
            t, port, hi, lo = m.groups()
            r = port_ranges.get(t, {}).get(port)
            if r is None:
                return None
            if hi is None:
                return _built_name(t), r[0], r[1]      # whole port
            if lo is None:
                return _built_name(t), r[0] + int(hi), 1
            a, b = int(hi), int(lo)
            return _built_name(t), r[0] + min(a, b), abs(a - b) + 1

        # <directlist> (Process_Directs): dedicated inter-block wires
        dl = root.find("directlist")
        if dl is not None:
            for d in dl.findall("direct"):
                a = d.attrib
                fp = _pin_index(a.get("from_pin", ""))
                tp = _pin_index(a.get("to_pin", ""))
                if fp is None or tp is None:
                    warnings.warn(f"{path}: direct "
                                  f"{a.get('name', '?')}: unresolvable "
                                  f"pin name; skipped")
                    continue
                if fp[2] != tp[2]:
                    warnings.warn(f"{path}: direct "
                                  f"{a.get('name', '?')}: from/to bit "
                                  f"widths differ; skipped")
                    continue
                sw = -1
                if a.get("switch_name"):
                    names = [x.name for x in arch.switches]
                    if a["switch_name"] in names:
                        sw = names.index(a["switch_name"])
                    else:
                        warnings.warn(
                            f"{path}: direct {a.get('name', '?')}: "
                            f"unknown switch {a['switch_name']!r}; "
                            f"using the delayless switch")
                for k in range(fp[2]):       # bitwise pairs over ranges
                    arch.directs.append(DirectSpec(
                        from_type=fp[0], from_pin=fp[1] + k,
                        to_type=tp[0], to_pin=tp[1] + k,
                        dx=int(float(a.get("x_offset", 0))),
                        dy=int(float(a.get("y_offset", 0))),
                        switch=sw))

        # per-pin Fc overrides: VPR8 <fc_override port_name=.../>, VPR7
        # <pin name=... fc_val=...> under <fc> (Process_Fc)
        for pb in ([cluster_pb] if cluster_pb is not None else []) \
                + hard_pbs:
            tname = pb.attrib.get("name", "")
            for fc in pb.iter("fc"):
                for ov in list(fc.findall("fc_override")) \
                        + list(fc.findall("pin")):
                    a = ov.attrib
                    pname = a.get("port_name") or a.get("name", "")
                    if "." not in pname:
                        pname = f"{tname}.{pname}"
                    val = _f(a, "fc_val", _f(a, "fc", -1.0))
                    pr = _pin_index(pname)
                    if pr is None or val < 0:
                        warnings.warn(f"{path}: fc override {pname!r} "
                                      f"unresolvable; skipped")
                        continue
                    t, base, width = pr
                    is_abs = a.get("fc_type", "frac").lower() == "abs"
                    for k in range(width):
                        if is_abs:
                            arch.Fc_pin_abs[(t, base + k)] = \
                                int(round(val))
                        else:
                            arch.Fc_pin[(t, base + k)] = val

        if cluster_pb is not None:
            num_in = sum(int(float(e.attrib.get("num_pins", 0)))
                         for e in cluster_pb.findall("input"))
            num_out = sum(int(float(e.attrib.get("num_pins", 0)))
                          for e in cluster_pb.findall("output"))
            if num_in:
                I = num_in
            if num_out:
                N = num_out
            # K from an inner LUT pb_type if present
            for inner in cluster_pb.iter("pb_type"):
                cls = inner.attrib.get("blif_model", "")
                if cls == ".names":
                    k_in = sum(int(float(e.attrib.get("num_pins", 0)))
                               for e in inner.findall("input"))
                    if k_in:
                        K = k_in
                    break
            # multi-mode cluster: hand the full <pb_type> tree to the
            # packer (ProcessPb_Type, read_xml_arch_file.c:2528; mode
            # choice + detail-route legality, cluster_legality.c).
            # Single-mode clusters keep the flat crossbar model.
            if next(cluster_pb.iter("mode"), None) is not None:
                from ..pack.pb_type import parse_pb_type
                try:
                    pb_tree_parsed = parse_pb_type(cluster_pb)
                    from ..pack.pb_pack import validate_pb_tree
                    validate_pb_tree(pb_tree_parsed)
                except (ValueError, KeyError) as e:
                    # structure/spec not supported -> flat-crossbar
                    # fallback; any OTHER exception is a parser bug and
                    # must propagate, not silently degrade packing
                    warnings.warn(
                        f"{path}: multi-mode cluster pb_type not "
                        f"representable ({type(e).__name__}: {e}); "
                        f"packing falls back to the flat crossbar "
                        f"model")
                else:
                    arch.pb_tree = pb_tree_parsed
    else:
        warnings.warn(f"{path}: no <complexblocklist>; using k6_N10 defaults")

    # Fc: prefer the logic cluster's own <fc>; fall back to <device>.  The io
    # pb_type's fc (typically 1.0) must never win, so no document-wide search.
    dev = root.find("device")
    # <switch_block type="wilton|subset|universal" fs="3">
    # (ProcessSwitchblocks): recorded on the Arch; the builder implements
    # its co-designed subset+rotated pattern and warns LOUDLY when the
    # XML asked for a different one — an explicit, visible approximation
    # instead of a silent one (rr/graph.py emits the warning)
    if dev is not None:
        sb = dev.find("switch_block")
        if sb is not None:
            arch.sb_type = sb.attrib.get("type", "subset").lower()
            arch.sb_fs = int(float(sb.attrib.get("fs", 3)))
    if not (cluster_pb is not None and _read_fc(cluster_pb)):
        if dev is not None:
            _read_fc(dev)

    # --- cluster timing (delay_constant / T_setup / T_clk_to_Q under the
    # cluster pb tree, ProcessPb_Type timing annotations) ---
    def _pb_timing(pb, defaults=(400e-12, 60e-12, 80e-12)):
        """Collapse the pb tree's timing annotations to the flat
        (T_comb, T_setup, T_clk_to_q) stand-in: the input->output
        combinational path is approximated as the worst interconnect
        delay_constant (crossbar stage) PLUS the worst primitive
        delay_matrix entry (LUT stage) — the two stage classes VPR7
        archs annotate (ProcessPb_Type/ProcessInterconnect timing)."""
        t_comb, t_setup, t_cq = defaults
        if pb is None:
            return t_comb, t_setup, t_cq
        dels = [_f(e.attrib, "max", 0.0) for e in pb.iter("delay_constant")]
        mats = []
        for e in pb.iter("delay_matrix"):
            for tok in (e.text or "").split():
                try:
                    mats.append(float(tok))
                except ValueError:
                    pass
        stage_ic = max(dels) if dels else 0.0
        stage_prim = max(mats) if mats else 0.0
        if stage_ic + stage_prim > 0:
            t_comb = stage_ic + stage_prim
        for e in pb.iter("T_setup"):
            t_setup = _f(e.attrib, "value", t_setup)
        for e in pb.iter("T_clk_to_Q"):
            t_cq = _f(e.attrib, "max", _f(e.attrib, "value", t_cq))
        return t_comb, t_setup, t_cq

    arch.K, arch.N, arch.I, arch.io_capacity = K, N, I, io_capacity
    t_comb, t_setup, t_cq = _pb_timing(cluster_pb)
    arch.block_types = [
        make_io_type(index=0, capacity=io_capacity),
        make_clb_type(index=1, K=K, N=N, I=I, T_comb=t_comb,
                      T_setup=t_setup, T_clk_to_q=t_cq),
    ]

    # --- heterogeneous hard blocks: pin counts + .subckt model mapping +
    # VPR7 <gridlocations><loc type="col" start= repeat=> columns ---
    for pb in hard_pbs:
        name = pb.attrib.get("name", f"hard{len(arch.block_types)}")
        num_in = sum(int(float(e.attrib.get("num_pins", 0)))
                     for e in pb.findall("input"))
        num_out = sum(int(float(e.attrib.get("num_pins", 0)))
                      for e in pb.findall("output"))
        if not num_in or not num_out:
            warnings.warn(f"{path}: pb_type {name} has no pins; skipped")
            continue
        ht_comb, ht_setup, ht_cq = _pb_timing(
            pb, (1.5e-9, 100e-12, 400e-12))
        arch.block_types.append(make_hard_type(
            name, index=len(arch.block_types), num_in=num_in,
            num_out=num_out, T_comb=ht_comb, T_setup=ht_setup,
            T_clk_to_q=ht_cq))
        for inner in pb.iter("pb_type"):
            model = inner.attrib.get("blif_model", "")
            toks = model.split(None, 1)
            if toks and toks[0] == ".subckt" and len(toks) > 1:
                arch.hard_models[toks[1].strip()] = name
        # one ColumnSpec per <loc type="col"> (VPR7 archs legally list
        # several column sets for one type)
        specs = []
        gl = pb.find("gridlocations")
        if gl is not None:
            for loc in gl.findall("loc"):
                if loc.attrib.get("type") == "col":
                    specs.append(ColumnSpec(
                        name,
                        start=int(float(loc.attrib.get("start", 4))),
                        repeat=int(float(loc.attrib.get("repeat", 8)))))
        arch.column_types.extend(specs or [ColumnSpec(name)])
    return arch
