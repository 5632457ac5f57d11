"""Placement: initial placement, the device annealer (sa.py), its
delay lookup, macros and legality audit, and the native serial
annealer's binding (serial_sa.py)."""

from .initial import initial_placement
from .macros import align_initial, form_macros
from .sa import (Placer, PlacerOpts, PlacerTiming, PlaceStats,
                 build_place_problem, net_bb_cost, net_td_cost)
from .delay_lookup import DelayLookup, compute_delay_lookup
