"""The port's copies of the JAX package's host modules — the XML arch
reader, frac_arch, multi-mode packing, BLIF I/O, the synthesis
generators, the .net / .place / .route files, the route report, power,
post-synthesis Verilog and SDF, the SVG and HTML views, the stats files
and the mdclog records — against the JAX package's on the same inputs.

Where a function takes a routed flow, both packages' functions are given
the port's flow, routed here on the CPU (plain versions of the kernels):
the comparison is of the host code, on one input."""

import dataclasses
import importlib
import json
import os
import sys
import warnings

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

PKGS = ("parallel_eda_tpu", "parallel_eda_tpu_torch")
GOLDEN_XML = os.path.join(REPO, "tests", "golden", "k6_frac_n10_mem.xml")
# an arch with a .subckt hard block in columns (tests/test_hetero.py)
HETERO_XML = """<architecture>
  <switchlist>
    <switch type="mux" name="0" R="551" Cin="7.7e-15" Cout="12.9e-15" Tdel="58e-12"/>
  </switchlist>
  <segmentlist>
    <segment freq="1" length="1" Rmetal="101" Cmetal="22.5e-15"><mux name="0"/></segment>
  </segmentlist>
  <complexblocklist>
    <pb_type name="io" capacity="8"/>
    <pb_type name="clb">
      <input name="I" num_pins="33"/>
      <output name="O" num_pins="10"/>
      <fc default_in_type="frac" default_in_val="0.15"
          default_out_type="frac" default_out_val="0.1"/>
      <pb_type name="ble"><pb_type name="lut" blif_model=".names">
        <input name="in" num_pins="6"/><output name="out" num_pins="1"/>
      </pb_type></pb_type>
    </pb_type>
    <pb_type name="bram" blif_model=".subckt spram">
      <input name="in" num_pins="9"/>
      <output name="out" num_pins="4"/>
      <clock name="clk" num_pins="1"/>
      <gridlocations><loc type="col" start="3" repeat="4"/></gridlocations>
    </pb_type>
  </complexblocklist>
</architecture>"""


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _both(name):
    return tuple(_mod(p, name) for p in PKGS)


def _plain(obj):
    """A dataclass tree as plain data (dicts, lists, numbers)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _netlist_from_blif(pkg, text):
    return _mod(pkg, "netlist.blif").parse_blif(text, K=6, name="c")


def _blif_text(tmp_path, nl):
    """The JAX package's BLIF of ``nl`` (a JAX LogicalNetlist)."""
    p = str(tmp_path / "c.blif")
    _mod(PKGS[0], "netlist.blif").write_blif(nl, p)
    with open(p) as f:
        return f.read()


@pytest.fixture(scope="module")
def routed():
    """The 15-LUT parity fixture, placed and routed timing-driven by the
    port on the CPU."""
    flow_mod = _mod(PKGS[1], "flow")
    from parallel_eda_tpu_torch.place.sa import PlacerOpts
    from parallel_eda_tpu_torch.route.router import RouterOpts

    f = flow_mod.synth_flow(num_luts=15, num_inputs=6, num_outputs=6,
                            chan_width=10, seed=3)
    flow_mod.run_place(f, PlacerOpts(moves_per_step=16, seed=3),
                       device="cpu")
    flow_mod.run_route(f, RouterOpts(batch_size=32), device="cpu")
    assert f.route.success
    return f


# ------------------------------------------------------------- arch ----

def test_read_arch_xml_golden_matches_jax():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ja, ta = (_mod(p, "arch.xml_parser").read_arch_xml(GOLDEN_XML)
                  for p in PKGS)
    assert _plain(ta) == _plain(ja)
    assert ta.segments[0].length == 4
    assert ta.segments[0].directionality == "unidir"


def test_read_arch_xml_hetero_matches_jax(tmp_path):
    p = tmp_path / "hetero.xml"
    p.write_text(HETERO_XML)
    ja, ta = (_mod(q, "arch.xml_parser").read_arch_xml(str(p))
              for q in PKGS)
    assert _plain(ta) == _plain(ja)
    assert ta.hard_models == {"spram": "bram"}


def test_frac_arch_matches_jax():
    ja, ta = (_mod(p, "arch.builtin").frac_arch(N=4, I=20, chan_width=14)
              for p in PKGS)
    assert ta.pb_tree is not None
    assert _plain(ta) == _plain(ja)


# ------------------------------------------------------------- pack ----

def _net_bytes(pkg, pnl, tmp_path, tag):
    p = str(tmp_path / f"{tag}.net")
    _mod(pkg, "netlist.files").write_net_file(pnl, p)
    return _read(p)


def test_pack_multimode_frac_arch_matches_jax(tmp_path):
    """Multi-mode pb packing (arch.pb_tree), which the port used to
    refuse: the same clusters as the JAX package, each re-verified as
    pb-routable by the port's own pb_cluster_feasible."""
    jnl = _mod(PKGS[0], "netlist.generate").generate_circuit(
        num_luts=30, num_inputs=8, num_outputs=6, K=6, seed=5,
        ff_ratio=0.4)
    text = _blif_text(tmp_path, jnl)
    nets = []
    for pkg in PKGS:
        arch = _mod(pkg, "arch.builtin").frac_arch(N=4, I=20, chan_width=14)
        nl = _netlist_from_blif(pkg, text)
        pnl = _mod(pkg, "pack.packer").pack_netlist(nl, arch)
        nets.append(_net_bytes(pkg, pnl, tmp_path, pkg))
    assert nets[0] == nets[1]
    # the port's clusters are legal under the pb tree
    packer = _mod(PKGS[1], "pack.packer")
    pb_pack = _mod(PKGS[1], "pack.pb_pack")
    bles = packer._form_bles(nl)
    prim_to_ble = {}
    for bi, b in enumerate(bles):
        for p in (b.lut, b.ff):
            if p is not None:
                prim_to_ble[p] = bi
    clbs = [blk for blk in pnl.blocks if blk.type_name == "clb"]
    assert len(clbs) >= 2
    for blk in clbs:
        members = {prim_to_ble[p] for p in blk.prims}
        assert pb_pack.pb_cluster_feasible(bles, members, set(nl.clocks),
                                           arch)


@pytest.mark.parametrize("arch_name", ["golden", "hetero"])
def test_pack_xml_arch_matches_jax(tmp_path, arch_name):
    if arch_name == "golden":
        path = GOLDEN_XML
        jnl = _mod(PKGS[0], "netlist.generate").generate_circuit(
            num_luts=40, num_inputs=8, num_outputs=8, K=6, seed=2)
    else:
        path = str(tmp_path / "hetero.xml")
        with open(path, "w") as f:
            f.write(HETERO_XML)
        jnl = _mod(PKGS[0], "netlist.synthesis").ram_pipeline(
            n_mems=2, addr_bits=4, data_bits=4)
    text = _blif_text(tmp_path, jnl)
    nets = []
    for pkg in PKGS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            arch = _mod(pkg, "arch.xml_parser").read_arch_xml(path)
        pnl = _mod(pkg, "pack.packer").pack_netlist(
            _netlist_from_blif(pkg, text), arch)
        nets.append(_net_bytes(pkg, pnl, tmp_path, pkg))
    assert nets[0] == nets[1]


# ------------------------------------------------------------- BLIF ----

GENERATORS = {
    "array_multiplier": dict(n=4),
    "ram_pipeline": dict(n_mems=2, addr_bits=4, data_bits=4),
    "crc_xor_tree": dict(width=8, data_bits=8),
}


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_synthesis_and_blif_roundtrip_match_jax(tmp_path, gen):
    """Each generator's netlist written as BLIF, then parsed and written
    again (.subckt blackboxes included): the same bytes from both
    packages, and the parse keeps every primitive."""
    texts, again, prims = [], [], []
    for pkg in PKGS:
        nl = getattr(_mod(pkg, "netlist.synthesis"), gen)(**GENERATORS[gen])
        blif = _mod(pkg, "netlist.blif")
        p = str(tmp_path / f"{pkg}.blif")
        blif.write_blif(nl, p)
        texts.append(_read(p))
        nl2 = blif.parse_blif(_read(p).decode(), K=6)
        p2 = str(tmp_path / f"{pkg}_again.blif")
        blif.write_blif(nl2, p2)
        again.append(_read(p2))
        prims.append([_plain(q) for q in nl2.primitives])
    assert texts[0] == texts[1]
    assert again[0] == again[1]
    assert prims[0] == prims[1]
    if gen == "ram_pipeline":
        assert b".subckt spram" in texts[1] and b".blackbox" in texts[1]


def test_read_blif_array_multiplier_16(tmp_path):
    """The tseng-class circuit the chip run takes: array_multiplier(16)
    through the port's BLIF writer and reader."""
    synth = _mod(PKGS[1], "netlist.synthesis")
    blif = _mod(PKGS[1], "netlist.blif")
    p = str(tmp_path / "mult16x16.blif")
    blif.write_blif(synth.array_multiplier(16), p)
    nl = blif.read_blif(p)
    assert nl.stats() == ("mult16x16: {'inpad': 33, 'outpad': 32, 'ff': 64, "
                          "'lut': 736}, 833 nets")


# ------------------------------------------------------------ files ----

def test_net_place_route_files_match_jax(tmp_path, routed, monkeypatch):
    """The .net (XML and the legacy JSON form), .place and .route writers
    and readers of both packages on the port's routed flow (each in a
    directory of its own, by the same relative path: the .place file
    names the .net file's)."""
    f = routed
    out = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        paths = _mod(pkg, "flow").save_artifacts(f, "out", prefix="c")
        out[pkg] = {k: _read(v) for k, v in paths.items()}
        files = _mod(pkg, "netlist.files")
        pnl = files.read_net_file(paths["net"], f.arch)
        out[pkg]["net_again"] = _net_bytes(pkg, pnl, tmp_path, pkg + "_a")
        pos, nx, ny = files.read_place_file(f.pnl, paths["place"])
        assert np.array_equal(pos, f.pos) and (nx, ny) == (f.grid.nx,
                                                           f.grid.ny)
        out[pkg]["routes"] = files.read_route_file(paths["route"])
    assert out[PKGS[0]] == out[PKGS[1]]
    routes = _mod(PKGS[1], "flow").routes_from_result(f.term, f.route,
                                                      f.rr.num_nodes)
    assert out[PKGS[1]]["routes"] == routes
    # the JSON .net form
    blocks = [dict(name=b.name, type=b.type_name, pin_nets=b.pin_nets,
                   prims=b.prims) for b in f.pnl.blocks]
    js = json.dumps(dict(name=f.pnl.name,
                         nets=[dict(name=n.name, **{"global": n.is_global})
                               for n in f.pnl.nets],
                         blocks=blocks))
    p = tmp_path / "c_json.net"
    p.write_text(js)
    got = [_net_bytes(pkg, _mod(pkg, "netlist.files").read_net_file(
        str(p), f.arch), tmp_path, pkg + "_j") for pkg in PKGS]
    assert got[0] == got[1]


def test_route_report_matches_jax(routed):
    f = routed
    jr, tr = _both("route.report")
    n = len(f.term.net_ids)
    assert tr.route_report(f.rr, f.route.occ, n) == jr.route_report(
        f.rr, f.route.occ, n)
    occ = f.route.occ.copy()
    occ[np.argsort(-f.rr.capacity)[:7]] += 3
    assert tr.overused_wire_nodes(f.rr, occ) == jr.overused_wire_nodes(
        f.rr, occ)


# ----------------------------------------------------- power, verilog ----

def test_estimate_power_matches_jax(routed):
    jp, tp = _both("power")
    j, t = jp.estimate_power(routed), tp.estimate_power(routed)
    assert str(t) == str(j)
    assert _plain(t) == _plain(j)


def test_write_post_synthesis_matches_jax(tmp_path, routed):
    got = []
    for pkg in PKGS:
        d = str(tmp_path / pkg)
        paths = _mod(pkg, "netlist.verilog").write_post_synthesis(routed, d)
        got.append({k: (os.path.basename(v), _read(v))
                    for k, v in paths.items()})
    assert got[0] == got[1]
    assert set(got[1]) >= {"verilog", "sdf"}


# ------------------------------------------------------------- views ----

def test_views_match_jax(tmp_path, routed):
    got = []
    for pkg in PKGS:
        draw, viewer = _mod(pkg, "draw"), _mod(pkg, "viewer")
        d = tmp_path / pkg
        d.mkdir()
        draw.write_placement_svg(routed, str(d / "placement.svg"))
        draw.write_routing_svg(routed, str(d / "routing.svg"))
        viewer.write_interactive_html(routed, str(d / "viewer.html"))
        got.append({n: _read(str(d / n)) for n in (
            "placement.svg", "routing.svg", "viewer.html")})
    assert got[0] == got[1]
    assert got[1]["routing.svg"].startswith(b"<svg")


# ------------------------------------------------- stats files, mdclog ----

def test_write_stats_files_matches_jax(tmp_path, routed):
    from parallel_eda_tpu.route import router as JR
    from parallel_eda_tpu_torch.route import router as TR

    got = []
    for tag, fn in (("jax", JR.write_stats_files),
                    ("port", TR.write_stats_files)):
        fn(str(tmp_path / tag), routed.route)
        got.append({n: _read(str(tmp_path / tag / n))
                    for n in ("iter_stats.txt", "final_stats.txt")})
    assert got[0] == got[1]


def test_mdclog_matches_jax(tmp_path):
    """The same records through both loggers: the same files and lines,
    but for each record's clock "t"."""
    records = [(1, "route", dict(iteration=1, K=1, rerouted=5)),
               (1, "congestion", dict(overused_nodes=3, pres_fac=0.5,
                                      top_overused=[[4, 2]])),
               (2, "schedule", dict(colors=3, precise=True)),
               (2, "timing", dict(crit_path_delay=3.9e-09,
                                  dmax_hist=[None, 3.9e-09]))]
    got = []
    for pkg in PKGS:
        mdclog = _mod(pkg, "mdclog")
        base = tmp_path / pkg
        with mdclog.MdcLogger(str(base)) as log:
            for w, cat, rec in records:
                log.set_mdc(w)
                log.log(cat, **dict(rec))
            with pytest.raises(ValueError):
                log.log("bogus", x=1)
        files = {}
        for root, _, names in os.walk(base):
            for n in names:
                p = os.path.join(root, n)
                lines = [json.loads(s) for s in open(p)]
                for rec in lines:
                    assert isinstance(rec.pop("t"), float)
                files[os.path.relpath(p, base)] = lines
        got.append(files)
    assert got[0] == got[1]
    assert len(got[1]) == 4
