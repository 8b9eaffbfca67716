from . import bimbam, kinship, plink, rawbin, streaming, traw  # noqa: F401
from .plink import read_bed, write_bed  # noqa: F401
from .traw import read_traw  # noqa: F401
from .rawbin import read_rawbin, write_rawbin, read_eigenvalues  # noqa: F401
from .streaming import SnpBlockStreamer  # noqa: F401
from .packed import PackedMatrix, write_rawbin_2bit  # noqa: F401
from .quantized import QuantizedMatrix, write_rawbin_i8  # noqa: F401
from .gemma_format import write_gemma_assoc  # noqa: F401
