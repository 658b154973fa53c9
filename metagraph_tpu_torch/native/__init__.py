"""The host FASTA/FastQ codec in C (``fasta_codec.c``), bound with ctypes."""

from .loader import fasta_encode_native, native_available, pack2_codes_native
