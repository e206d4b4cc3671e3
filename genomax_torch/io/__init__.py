"""Input and output formats of the port, copies of ``genomax.io``:
``formats`` (the SW pairs file and the PairHMM batch file), ``phred``
(quality decode) and ``generator`` (seeded synthetic inputs)."""

from genomax_torch.io.formats import (  # noqa: F401
    PairHMMBatch,
    PairHMMRead,
    SWPair,
    parse_pairhmm_file,
    parse_sw_file,
    write_pairhmm_output,
)
from genomax_torch.io.phred import phred_to_error_prob  # noqa: F401
