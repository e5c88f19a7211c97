from .common import pad_axis, pad_to_multiple, unpack_bits_device
from .emissions import emat_read_from_bits, log_emat_dh_from_gl, PaddedReads
from .fb_full import fb_full_batched, FBInputs

__all__ = [
    "pad_axis",
    "pad_to_multiple",
    "unpack_bits_device",
    "log_emat_dh_from_gl",
    "emat_read_from_bits",
    "PaddedReads",
    "fb_full_batched",
    "FBInputs",
]
