"""System serialization: YAML / JSON / text / array round-trip.

Behavioral parity with reference formats.py:29-104; the dict schema
matches the reference so prescriptions written for either
implementation load in both.
"""

import json

import numpy as np
import yaml

from .system import System
from .elements import Spheroid
from .materials import Material


class _Row:
    """Column accessor over one line of a tabular prescription."""

    def __init__(self, columns, line):
        self.columns = columns
        self.line = line

    def get(self, field, default=None):
        if field not in self.columns:
            return default
        raw = self.line[self.columns.index(field)]
        try:
            return float(raw)
        except ValueError:
            return raw


def try_get(line, columns, field, default=None):
    return _Row(columns, line).get(field, default)


def _surface_from_row(row, material_map):
    """One table row -> a Spheroid (curvature from `curvature` or
    `roc`, radius from `radius` or half `diameter`)."""
    el = Spheroid()
    curv = row.get("curvature")
    if curv is None:
        roc = row.get("roc", 0.)
        curv = 1./roc if roc else 0.
    el.curvature = curv
    el.distance = row.get("distance", 0.)
    el.radius = row.get("radius", 0.) or row.get("diameter", 0.)/2.
    mat = row.get("material")
    el.material = Material.make(material_map.get(mat, mat))
    return el


def system_from_array(data,
                      columns="type roc distance diameter material".split(),
                      shifts={}, material_map={}, **kwargs):
    """Build a System from a column table (reference formats.py:40):
    one row per surface, column meanings given by `columns`."""
    table = np.array(data)
    assert table.ndim == 2
    for field, amount in shifts.items():
        col = columns.index(field)
        table[:, col] = np.roll(table[:, col], amount)
    s = System(**kwargs)
    for line in table:
        row = _Row(columns, line)
        el = _surface_from_row(row, material_map)
        s.append(el)
        kind = row.get("type", "S")
        if kind == "A":
            s.aperture = el
        elif kind == "O" and el.radius:
            # the object row's aperture describes the field: an angular
            # radius for an infinite conjugate, a height otherwise
            # (reference formats.py:69 stored this on a dead attribute)
            if s.object.finite:
                s.object.radius = el.radius
            else:
                s.object.angle = el.radius
    return s


def system_from_text(text, *args, **kwargs):
    """Whitespace table -> System: keeps only the rows with the modal
    column count (reference formats.py:78)."""
    rows = [line.split() for line in text.splitlines()]
    width = max(len(r) for r in rows)
    return system_from_array([r for r in rows if len(r) == width],
                             *args, **kwargs)


def _check_system_dict(dat, kind):
    if not isinstance(dat, dict):
        raise ValueError("expected a %s mapping describing a system, "
                         "got %r" % (kind, type(dat).__name__))
    typ = dat.pop("type", "system")
    if typ != "system":
        raise ValueError("not a system description (type: %r)" % typ)
    return dat


def system_from_yaml(text):
    return System(**_check_system_dict(yaml.safe_load(text), "YAML"))


def system_to_yaml(system):
    return yaml.dump(system.dict(), default_flow_style=None)


def system_from_json(text):
    return System(**_check_system_dict(json.loads(text), "JSON"))


def system_to_json(system):
    return json.dumps(system.dict())
