"""Visualization: matplotlib grid/mesh plotting (host numpy; matplotlib is
imported only when a plot is drawn)."""
from . import mpl, myv

__all__ = ["mpl", "myv"]
