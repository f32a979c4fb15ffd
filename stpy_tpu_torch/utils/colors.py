"""Named colour palette for plots: the port of stpy_tpu/utils/colors.py
(a self-contained palette with the lookup surface of an X11 colour
database)."""

_PALETTE = {
    "red": (220, 38, 38), "blue": (37, 99, 235), "green": (22, 163, 74),
    "orange": (234, 88, 12), "purple": (147, 51, 234), "teal": (13, 148, 136),
    "pink": (219, 39, 119), "gray": (107, 114, 128), "black": (0, 0, 0),
    "yellow": (202, 138, 4), "brown": (120, 53, 15), "cyan": (8, 145, 178),
}


def find_byname(name):
    return _PALETTE[name.lower()]


def rrggbb_to_triplet(s):
    s = s.lstrip("#")
    return tuple(int(s[i : i + 2], 16) for i in (0, 2, 4))


def triplet_to_rrggbb(t):
    return "#%02x%02x%02x" % t


def cycle(n):
    names = list(_PALETTE)
    return [triplet_to_rrggbb(_PALETTE[names[i % len(names)]]) for i in range(n)]
