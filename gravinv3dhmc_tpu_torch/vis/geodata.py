"""Embedded map-decoration data: coarse coastlines and country borders.

The reference delegates coastline/border drawing to the Basemap toolkit's
bundled GSHHS datasets (reference: vis/mpl.py:75-112). Basemap is dead
upstream and this build is offline, so two sources replace it:

* :data:`WORLD_COASTLINES` / :data:`WORLD_BORDERS` — a hand-digitised
  coarse vector set (~2-5 degree fidelity) for global-scale orientation.
  It is deliberately small (a few hundred vertices) and is NOT survey
  quality; pass ``source=`` with your own polyline file for production
  figures.
* :func:`coastline_from_topo_grd` — an *exact* regional coastline taken
  as the zero contour of a Surfer topography grid (e.g. the South China
  ``topo_12d05d.grd`` the realdata workload already loads;
  reference: example/realdata/data/).

The port's copy of ``gravinv3dhmc_tpu/vis/geodata.py``, data and
functions unchanged (``tests/test_torch_vis.py`` holds them bit for bit).

Polyline file format for ``load_segments``: whitespace-separated
``lon lat`` pairs, one per line, segments separated by blank lines or
``>`` lines (GMT/psxy convention, which Natural Earth exports support).
"""
from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# coarse world vectors (hand-digitised; lon in [-180, 180], lat degrees)
# --------------------------------------------------------------------------

_NORTH_AMERICA = [
    (-168, 65.5), (-161, 70.3), (-156, 71.3), (-141, 69.6), (-128, 70),
    (-115, 68.5), (-95, 69), (-85, 70), (-82, 66), (-86, 64), (-88, 60),
    (-94, 59), (-92, 57), (-85, 55.5), (-79, 54.5), (-79, 51.5),
    (-73.5, 55.5), (-70, 58.5), (-65, 59.5), (-64, 56), (-60, 55.5),
    (-55.5, 51.5), (-56, 49), (-60, 46), (-64, 45.5), (-66, 44),
    (-70, 43.5), (-70, 41.7), (-74, 40.5), (-75.5, 38), (-76, 35),
    (-80.5, 32), (-81, 30.5), (-80, 26.5), (-81, 25), (-82.5, 27.5),
    (-84, 30), (-88, 30.2), (-91, 29), (-94, 29.5), (-97, 26),
    (-97.5, 22), (-95, 19), (-91, 18.8), (-90, 21.2), (-87, 21.5),
    (-88.5, 18), (-86, 15.5), (-83.5, 15), (-82, 12), (-80, 9.5),
    (-77.5, 7.9), (-79.5, 9), (-81.5, 8), (-85, 10), (-87.5, 13),
    (-91.5, 14), (-95, 16), (-97, 17), (-101, 17.5), (-105, 20),
    (-106, 23.5), (-109, 25.5), (-112, 27), (-114, 30), (-117, 32.5),
    (-120, 34.5), (-122, 37), (-124, 40), (-124, 44), (-123.5, 48),
    (-128, 51), (-132, 54), (-136, 57), (-140, 59.5), (-146, 60.5),
    (-151, 59), (-154, 58), (-158, 56), (-163, 54.5), (-166, 54),
    (-162, 58), (-166, 61), (-166, 63), (-168, 65.5),
]

_SOUTH_AMERICA = [
    (-77.5, 7.5), (-75.5, 10.5), (-72, 12), (-68, 11), (-63, 10.7),
    (-60, 9), (-55, 6), (-51, 4.5), (-50, 0), (-44.5, -2.5),
    (-39.5, -3.5), (-35, -5.5), (-34.8, -8), (-39, -13), (-39, -17.5),
    (-41, -22), (-48, -25.5), (-48.7, -28.5), (-52, -32), (-56, -34.7),
    (-58, -38.5), (-62, -39), (-62.5, -42), (-65, -45), (-67.5, -46),
    (-65.5, -47.5), (-69, -50.5), (-68.5, -52.5), (-66, -55), (-72, -54),
    (-74, -52), (-73, -48), (-74.5, -45), (-73, -42), (-73.5, -37.5),
    (-71.5, -32.5), (-70.5, -25), (-70, -18.5), (-75.5, -14.5), (-81, -6),
    (-80, -3), (-77, 1.5), (-78.8, 6.5), (-77.5, 7.5),
]

_AFRICA = [
    (-6, 35.5), (0, 36.8), (10, 37), (11, 33.5), (15, 32), (20, 32.5),
    (25, 31.5), (32, 31), (34, 27.5), (37, 21), (43, 11.5), (51.3, 11.8),
    (48, 5), (41, -2), (40.5, -10.5), (35, -18), (35.5, -24), (32, -29),
    (26, -34), (20, -34.5), (18, -32), (15, -27), (12, -18), (13.5, -12),
    (9, -1), (8.5, 4.5), (5, 6), (-4, 5.2), (-8, 4.5), (-13, 9),
    (-17, 14.5), (-16, 20), (-10, 28), (-9.5, 31.5), (-6, 35.5),
]

_EURASIA = [
    (-9.5, 43.8), (-2, 43.5), (0, 45.5), (-1, 46.5), (-4.5, 48.5),
    (2, 51), (4.5, 53), (8, 55), (8, 57), (10.8, 59), (5, 62),
    (14, 68), (25, 71), (30, 70), (41, 66.5), (44, 68), (54, 69),
    (60, 69.5), (75, 72.5), (82, 75), (95, 76), (105, 77.5), (113, 74),
    (130, 72), (140, 72.5), (150, 71), (160, 70), (170, 70), (179.5, 68),
    (179.5, 65), (170, 60), (162, 56), (156, 51), (155, 59), (142, 59),
    (141, 53), (140, 48), (135, 44.5), (132, 43), (129.5, 42), (129, 40),
    (129.5, 37), (126.5, 34.5), (125, 38), (124, 39.5), (122, 40.5),
    (118, 39), (122, 37.5), (120, 35), (122, 31), (120, 28), (117, 24.5),
    (113, 22), (110, 20.5), (108, 21.5), (106, 20), (109, 15),
    (107, 10.5), (105, 9), (103, 10.5), (100, 13.5), (99, 8), (103, 1.5),
    (100, 6), (98, 10), (97.5, 16), (94.5, 16), (91, 22), (88, 21.5),
    (85, 19.5), (80, 15.5), (77, 8), (73, 15.5), (70, 21), (72, 24),
    (67, 24.5), (61, 25), (56.5, 27), (50, 30), (48, 29), (51, 24),
    (56, 24), (58, 22), (57, 17), (53, 16), (43, 12.5), (39, 15),
    (35, 28), (32.5, 30), (34, 31), (36, 36), (30, 36.5), (27, 37),
    (26, 40), (29, 41), (41, 41), (37, 45), (34, 45), (30, 46.5),
    (28, 41), (23, 40), (24, 37), (21, 37), (19, 40), (16, 41.8),
    (18.5, 40.3), (16, 38), (12, 41.5), (10.5, 44), (7.5, 43.7), (3, 43),
    (0, 39.5), (-2, 36.7), (-5.5, 36), (-9, 37), (-9.5, 43.8),
]

_AUSTRALIA = [
    (113, -22), (114, -26), (115.5, -32), (119, -34.5), (124, -33),
    (129, -32), (132, -32), (135.5, -35), (138, -35.5), (140, -38),
    (145, -38.5), (147, -38), (150, -37), (153, -30), (153.5, -27),
    (151, -24), (149, -20), (146, -18), (143, -14), (142.5, -10.8),
    (141, -14), (136, -12), (132, -11), (130, -12.5), (126, -14),
    (122, -17), (118, -20), (113, -22),
]

_GREENLAND = [
    (-45, 60), (-40, 64), (-32, 68.5), (-25, 70.5), (-22, 73), (-20, 76),
    (-23, 78.5), (-32, 81), (-45, 82.5), (-58, 82), (-68, 80),
    (-72, 78.5), (-68, 76), (-60, 75.5), (-56, 73), (-54, 70), (-53, 67),
    (-50, 64), (-48, 61), (-45, 60),
]

_ISLANDS = [
    # Britain / Ireland
    [(-5.5, 50), (0.5, 50.8), (1.5, 52.5), (-0.5, 54), (-2, 56),
     (-3, 58), (-5, 58.5), (-6, 57), (-5, 55), (-3, 53.5), (-4.5, 52),
     (-5.5, 50)],
    [(-6, 52), (-9.5, 51.5), (-10, 53.5), (-8, 55.3), (-6, 54), (-6, 52)],
    # Iceland
    [(-22, 64), (-15, 64), (-14, 65.5), (-18, 66.5), (-24, 65.5),
     (-22, 64)],
    # Japan: Hokkaido, Honshu, Kyushu
    [(140.5, 42), (143, 42), (145.5, 43.5), (142, 45.5), (140.5, 42)],
    [(141, 41.5), (141.5, 38), (140, 36), (139.8, 34.8), (137, 34.5),
     (135, 33.5), (132, 34), (131, 34.5), (135, 35.5), (137, 37),
     (140, 39), (141, 41.5)],
    [(130, 31), (131.5, 33), (129.5, 33.5), (130, 31)],
    # Taiwan / Hainan (the realdata South China region)
    [(120.2, 22.6), (121.0, 25.0), (121.9, 24.9), (120.8, 22.6),
     (120.2, 22.6)],
    [(108.6, 19.3), (110.6, 20.0), (111.0, 19.1), (109.6, 18.2),
     (108.6, 19.3)],
    # Sri Lanka
    [(80, 9.8), (81.8, 7.5), (80.5, 5.9), (79.8, 8), (80, 9.8)],
    # Madagascar
    [(49.5, -12.2), (50.5, -15.5), (47, -25), (45, -25.5), (43.5, -21),
     (44, -16), (48, -13), (49.5, -12.2)],
    # Sumatra / Java / Borneo / New Guinea
    [(95.5, 5.5), (102, -4), (106, -6), (104, -2), (98, 2.5), (95.5, 5.5)],
    [(105.5, -6.8), (113.5, -7.7), (110, -6.9), (105.5, -6.8)],
    [(109, 1.5), (113, 4.5), (117, 7), (119, 1), (116, -3.5), (110, -1.5),
     (109, 1.5)],
    [(131, -1), (135, -2.5), (141, -2.7), (147, -6), (143, -8.5),
     (138, -7), (132, -3), (131, -1)],
    # Philippines: Luzon, Mindanao
    [(120.5, 18.5), (122.2, 17), (121.5, 14), (120, 14.5), (120.5, 18.5)],
    [(122, 9.5), (126.5, 9), (125.5, 6), (122, 6.5), (122, 9.5)],
    # New Zealand
    [(173, -34.5), (178, -37.5), (176, -41.3), (174.5, -38.8),
     (173, -34.5)],
    [(173, -40.8), (174, -41.5), (171, -44), (168, -46.5), (166.5, -45.8),
     (170, -43), (173, -40.8)],
    # Cuba
    [(-84.9, 21.9), (-80, 23.2), (-74.2, 20.2), (-77.5, 20),
     (-84.9, 21.9)],
]


def _antarctica():
    lons = np.arange(-180.0, 181.0, 10.0)
    lats = -70.5 - 2.0 * np.cos(np.radians(2.0 * lons))
    # Antarctic Peninsula bump toward South America
    lats = np.where(np.abs(lons + 60) < 15, -64.0, lats)
    return list(zip(lons.tolist(), lats.tolist()))


#: list of (lon, lat) polylines — the coarse world coastline
WORLD_COASTLINES = ([_NORTH_AMERICA, _SOUTH_AMERICA, _AFRICA, _EURASIA,
                     _AUSTRALIA, _GREENLAND, _antarctica()] + _ISLANDS)

#: a small set of major land borders (same fidelity caveat)
WORLD_BORDERS = [
    # US–Canada (49th parallel + Great Lakes / St. Lawrence)
    [(-123, 49), (-95, 49), (-89, 48), (-84, 46.5), (-82, 45),
     (-79, 43.5), (-75, 45), (-71, 45), (-69, 47.3)],
    # US–Mexico
    [(-117, 32.5), (-111, 31.3), (-108, 31.8), (-106.5, 31.8), (-103, 29),
     (-101, 29.8), (-99, 27.5), (-97.2, 25.9)],
    # Russia–China / Mongolia arc
    [(87, 49), (98, 52), (110, 50), (117, 48), (120, 53), (127, 50),
     (131, 48), (134, 48.5), (131, 45), (131, 42.5)],
    # China western / Himalayan border chain
    [(87, 49), (83, 47), (80, 45), (76, 40.5), (74, 37), (78, 32),
     (81, 30.5), (85, 28.5), (89, 28), (92, 27.5), (97, 28), (99, 22),
     (102, 22.5), (105, 23), (108, 21.5)],
    # India–Pakistan
    [(68, 24), (71, 28), (74, 32), (76, 34)],
    # western Russia / eastern Europe
    [(28, 70), (30, 62), (28, 56), (24, 54), (23, 51), (26, 48),
     (30, 46)],
    # Pyrenees and Alps chains
    [(-1.8, 43.3), (3, 42.5)],
    [(6, 49), (7.5, 47.7), (10, 46.5), (13.7, 46.5), (16, 46.8)],
]


# --------------------------------------------------------------------------
# segment utilities
# --------------------------------------------------------------------------

def _clip_segment(seg, area):
    """Split a polyline into the pieces inside area=(w, e, s, n); one-point
    margin so lines run to the frame edge."""
    w, e, s, n = area
    lon = seg[:, 0]
    lat = seg[:, 1]
    inside = (lon >= w) & (lon <= e) & (lat >= s) & (lat <= n)
    keep = inside.copy()
    keep[:-1] |= inside[1:]
    keep[1:] |= inside[:-1]
    pieces = []
    start = None
    for i, k in enumerate(keep):
        if k and start is None:
            start = i
        elif not k and start is not None:
            if i - start >= 2:
                pieces.append(seg[start:i])
            start = None
    if start is not None and len(seg) - start >= 2:
        pieces.append(seg[start:])
    return pieces


def coastline_segments(area=None, source=None):
    """(lon, lat) polylines for ``area=(west, east, south, north)``.

    ``source`` may be a polyline text file (``load_segments`` format) or a
    Surfer topography ``.grd`` whose zero contour is the coastline;
    default is the embedded coarse world set.
    """
    if source is None:
        segs = [np.asarray(s, float) for s in WORLD_COASTLINES]
    elif str(source).endswith(".grd"):
        segs = coastline_from_topo_grd(source)
    else:
        segs = load_segments(source)
    if area is None:
        return segs
    out = []
    for s in segs:
        out.extend(_clip_segment(s, area))
    return out


def border_segments(area=None, source=None):
    """Country-border polylines (same conventions as
    :func:`coastline_segments`)."""
    if source is None:
        segs = [np.asarray(s, float) for s in WORLD_BORDERS]
    else:
        segs = load_segments(source)
    if area is None:
        return segs
    out = []
    for s in segs:
        out.extend(_clip_segment(s, area))
    return out


def load_segments(path):
    """Read ``lon lat`` polylines; blank or ``>`` lines split segments
    (GMT/psxy convention)."""
    segs = []
    cur = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith((">", "#")):
                if len(cur) >= 2:
                    segs.append(np.asarray(cur, float))
                cur = []
                continue
            parts = line.split()
            cur.append((float(parts[0]), float(parts[1])))
    if len(cur) >= 2:
        segs.append(np.asarray(cur, float))
    return segs


def coastline_from_topo_grd(path, level=0.0):
    """Exact regional coastline: the ``level`` contour of a Surfer
    topography grid (reference ships one for South China,
    example/realdata/data/topo_12d05d.grd)."""
    from ..utils import grdload

    g = grdload(path)
    z2 = np.asarray(g.data, float).reshape(g.nrow, g.ncol)
    lons = np.linspace(g.xmin, g.xmax, g.ncol)
    lats = np.linspace(g.ymin, g.ymax, g.nrow)
    import contourpy

    gen = contourpy.contour_generator(lons, lats, z2)
    lines = gen.lines(level)
    return [np.asarray(v, float) for v in lines if len(v) >= 2]
