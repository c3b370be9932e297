"""FL-APU core, ported slice by slice: the secure-aggregation data plane
(packing, pairwise masks, streaming fold). The control plane (governance,
jobs, board, protocol, server, client) is not ported yet."""
from repro_torch.core.packing import (PackedLayout, pack_many,  # noqa: F401
                                      pack_pytree, unpack_pytree)
from repro_torch.core.streaming import (MaskedF32Sink,  # noqa: F401
                                        stream_masked_packed)
