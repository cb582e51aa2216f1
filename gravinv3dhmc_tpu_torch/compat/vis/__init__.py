"""vis compat package (reference: vis/)."""
from ...vis import mpl, myv  # noqa: F401
