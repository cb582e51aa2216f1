"""Array-backed 3-D meshes (numpy copies of ``gravinv3dhmc_tpu/mesher``)."""
from .geometry import GeometricElement, Prism, Tesseroid
from .mesh import (PrismMesh, PrismMeshSegment, PrismRelief,
                   StructuredMesh3D, TesseroidMesh, TesseroidMeshSegment)

__all__ = ["GeometricElement", "Prism", "Tesseroid", "StructuredMesh3D",
           "PrismMesh", "PrismMeshSegment", "TesseroidMesh",
           "TesseroidMeshSegment", "PrismRelief"]
