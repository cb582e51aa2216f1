"""Array-backed 3-D meshes (numpy copies of ``gravinv3dhmc_tpu/mesher``)."""
from .geometry import GeometricElement, Prism
from .mesh import PrismMesh, StructuredMesh3D

__all__ = ["GeometricElement", "Prism", "StructuredMesh3D", "PrismMesh"]
