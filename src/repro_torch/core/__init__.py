"""FL-APU core, ported slice by slice: the secure-aggregation data plane
(packing, pairwise fp32 and integer masks, streaming folds), the
compressed and masked-quantized planes (``compression``), the Model
Aggregator strategies (``aggregation``) and ``protocol.pack_delta``. The
control plane (governance, jobs, board, the protocol phases, server,
client) is not ported yet."""
from repro_torch.core.packing import (PackedLayout, pack_many,  # noqa: F401
                                      pack_pytree, unpack_pytree)
from repro_torch.core.streaming import (MaskedF32Sink,  # noqa: F401
                                        ModularSink, QuantSink, TopkSink,
                                        stream_masked_packed)
