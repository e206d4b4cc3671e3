"""Packing of the port: ``bucketing`` lays ragged jobs out as dense numpy
tiles (a copy of ``genomax.pack.bucketing``), ``nibble`` is the SW
transfer ladder (the stream band and two codes a byte), ``tensors`` puts a
packed bucket on a device."""

from genomax_torch.pack.bucketing import (  # noqa: F401
    PairHMMPacked,
    StreamBand,
    SWPacked,
    pack_pairhmm_batches,
    pack_sw_pairs,
    unpack_scores,
)
from genomax_torch.pack.tensors import (  # noqa: F401
    phmm_bucket_to_torch,
    sw_bucket_to_torch,
    sw_rotor_to_torch,
    sw_stacked_to_torch,
    sw_strips_to_torch,
)
