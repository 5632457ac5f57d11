"""SDC timing-constraint parser (subset).

Equivalent of the reference's SDC reader (vpr/SRC/timing/read_sdc.c, regex
via slre.c): the subset that drives its analysis —

  create_clock -period <ns> [-name <name>] [<ports> | [get_ports {...}]]
  set_clock_groups -exclusive -group {...} -group {...}   (parsed, noted)
  set_input_delay -clock <clk> <ns> <ports>     (read_sdc.c:44)
  set_output_delay -clock <clk> <ns> <ports>    (read_sdc.c:46)
  set_multicycle_path -setup [-from <clk>] [-to <clk>] <N>  (:50)
  set_false_path ...                                       (ignored rows)

I/O delays model the external path share: an input port's arrival seed
becomes the declared delay; an output port's required time becomes its
clock period minus the declared delay.  A setup multicycle multiplies
the matching constraint's period by N.  Hold constraints
(set_multicycle_path -hold) are accepted and ignored — the analysis is
setup-only, like the reference's default flow.  Path-endpoint matching
is by CLOCK DOMAIN: a -from without matching -to applies to paths into
any domain (the reference's per-domain-pair constraint matrix,
read_sdc.c, collapsed onto the sink-domain axis our single-pass STA
resolves; see sta.TimingAnalyzer).

Periods are given in ns (VPR convention) and stored in seconds.  When no
SDC is supplied the flow behaves as before: a single ideal clock whose
required time is the critical-path delay itself (path_delay.c behavior
when read_sdc finds no file).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

NS = 1e-9


@dataclass
class SdcConstraints:
    # clock (net/port name) -> period in seconds
    clock_periods: Dict[str, float] = field(default_factory=dict)
    # clocks declared with -name only (virtual clocks)
    virtual_clocks: Dict[str, float] = field(default_factory=dict)
    # exclusive clock groups (set_clock_groups -exclusive)
    exclusive_groups: List[List[str]] = field(default_factory=list)
    # port -> (reference clock | None, external delay seconds)
    input_delays: Dict[str, Tuple[Optional[str], float]] = \
        field(default_factory=dict)
    output_delays: Dict[str, Tuple[Optional[str], float]] = \
        field(default_factory=dict)
    # setup multicycles: (from_clock | None, to_clock | None, N)
    multicycles: List[Tuple[Optional[str], Optional[str], int]] = \
        field(default_factory=list)

    @property
    def default_period(self) -> Optional[float]:
        """Fallback period for unconstrained domains: the slowest declared
        clock (conservative)."""
        vals = list(self.clock_periods.values()) + \
            list(self.virtual_clocks.values())
        return max(vals) if vals else None

    def period_of(self, clock_name: Optional[str]) -> Optional[float]:
        if clock_name in self.clock_periods:
            return self.clock_periods[clock_name]
        if clock_name in self.virtual_clocks:
            return self.virtual_clocks[clock_name]
        return self.default_period

    def multicycle_for(self, to_clock: Optional[str]) -> int:
        """Setup-constraint multiplier for paths clocked into
        ``to_clock`` (read_sdc.c set_multicycle_path application,
        collapsed onto the sink domain — see module docstring)."""
        m = 1
        for _frm, to, n in self.multicycles:
            if to is None or to == to_clock:
                m = max(m, n)
        return m


def _tokens(text: str) -> List[List[str]]:
    """Logical SDC commands -> token lists; unwraps [get_ports {...}],
    braces and brackets (the slre-regex equivalent, read_sdc.c)."""
    cmds: List[List[str]] = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        for drop in ("[get_ports", "[get_clocks", "{", "}", "[", "]"):
            line = line.replace(drop, " ")
        toks = [t for t in line.split() if t]
        if toks:
            cmds.append(toks)
    return cmds


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _arg(toks: List[str], i: int, cmd: str) -> str:
    """Value of the flag at toks[i]; descriptive error at end-of-line."""
    if i + 1 >= len(toks):
        raise ValueError(f"{cmd}: {toks[i]} needs a value")
    return toks[i + 1]


def parse_sdc(text: str) -> SdcConstraints:
    sdc = SdcConstraints()
    for toks in _tokens(text):
        cmd = toks[0]
        if cmd == "create_clock":
            period = None
            cname = None
            ports: List[str] = []
            i = 1
            while i < len(toks):
                if toks[i] == "-period":
                    period = float(_arg(toks, i, cmd)) * NS
                    i += 2
                elif toks[i] == "-name":
                    cname = _arg(toks, i, cmd)
                    i += 2
                elif toks[i] in ("-add",):
                    i += 1          # known valueless flag
                elif toks[i] == "-waveform":
                    # consume the numeric edge list (braces were dropped
                    # by the tokenizer, so take all following numbers)
                    i += 1
                    while i < len(toks) and _is_number(toks[i]):
                        i += 1
                elif toks[i].startswith("-"):
                    # guessing an unknown option's arity can swallow a
                    # port name and silently mis-assign the clock
                    raise ValueError(
                        f"create_clock: unknown option {toks[i]}")
                else:
                    ports.append(toks[i])
                    i += 1
            if period is None:
                raise ValueError("create_clock without -period")
            if ports:
                for p in ports:
                    sdc.clock_periods[p] = period
            elif cname is not None:
                sdc.virtual_clocks[cname] = period
            else:
                raise ValueError("create_clock needs -name or ports")
        elif cmd == "set_clock_groups":
            group: List[str] = []
            groups: List[List[str]] = []
            i = 1
            while i < len(toks):
                if toks[i] == "-group":
                    if group:
                        groups.append(group)
                    group = []
                    i += 1
                elif toks[i].startswith("-"):
                    i += 1
                else:
                    group.append(toks[i])
                    i += 1
            if group:
                groups.append(group)
            sdc.exclusive_groups.extend(groups)
        elif cmd in ("set_input_delay", "set_output_delay"):
            clk = None
            delay = None
            is_min = False
            ports: List[str] = []
            i = 1
            while i < len(toks):
                if toks[i] == "-clock":
                    clk = _arg(toks, i, cmd)
                    i += 2
                elif toks[i] == "-min":
                    is_min = True
                    i += 1
                elif toks[i] in ("-max", "-add_delay"):
                    i += 1
                # numeric check first: negative delays ('-0.5') are
                # legal SDC and must not be mistaken for flags
                elif delay is None and _is_number(toks[i]):
                    delay = float(toks[i]) * NS
                    i += 1
                elif toks[i].startswith("-") and not _is_number(toks[i]):
                    raise ValueError(f"{cmd}: unknown option {toks[i]}")
                else:
                    ports.append(toks[i])
                    i += 1
            if delay is None or not ports:
                raise ValueError(f"{cmd} needs a delay and ports")
            if is_min:
                # setup-only analysis: -min constraints are hold-side
                # (accepted, ignored) and must NOT overwrite the -max
                # entry of the canonical -max/-min pair
                continue
            tgt = (sdc.input_delays if cmd == "set_input_delay"
                   else sdc.output_delays)
            for p in ports:
                tgt[p] = (clk, delay)
        elif cmd == "set_multicycle_path":
            frm = to = None
            n = None
            hold = False
            i = 1
            while i < len(toks):
                if toks[i] == "-setup":
                    i += 1
                elif toks[i] == "-hold":
                    hold = True
                    i += 1
                elif toks[i] == "-from":
                    frm = _arg(toks, i, cmd)
                    i += 2
                elif toks[i] == "-to":
                    to = _arg(toks, i, cmd)
                    i += 2
                elif toks[i].startswith("-"):
                    raise ValueError(
                        f"set_multicycle_path: unknown option {toks[i]}")
                elif _is_number(toks[i]):
                    n = int(float(toks[i]))
                    i += 1
                else:
                    raise ValueError(
                        f"set_multicycle_path: unexpected {toks[i]}")
            if hold:
                continue        # setup-only analysis (read_sdc.c flow)
            if n is None or n < 1:
                raise ValueError("set_multicycle_path needs N >= 1")
            if frm is not None and frm != to:
                # the sink-domain STA (module docstring) cannot honor a
                # source-domain qualifier: say so instead of silently
                # relaxing every path into the -to domain
                warnings.warn(
                    f"set_multicycle_path -from {frm}"
                    + (f" -to {to}" if to is not None else "")
                    + ": the -from qualifier is not modeled; the "
                    "multiplier applies to every path clocked into "
                    + (f"'{to}'" if to is not None else "any domain")
                    + " regardless of source clock")
            sdc.multicycles.append((frm, to, n))
        elif cmd == "set_false_path":
            continue            # accepted, not modeled (subset)
        else:
            raise ValueError(f"unsupported SDC command: {cmd}")
    return sdc


def read_sdc(path: str) -> SdcConstraints:
    with open(path) as f:
        return parse_sdc(f.read())
