"""FL-APU core: the paper's architecture as working components, ported
to PyTorch.

Server containers (paper §V): GovernanceCockpit (+contracts), JobCreator,
ClientManagement, FLServer (FL Manager/Run Manager + coordinators +
Model Aggregator + Model Deployer), MessageBoard/ServerCommunicator,
MetadataStore, reporting.

Client containers (paper §VI): FLClientNode (FL Pipeline + Client Model
Deployer + Inference Manager + Model Monitoring), ClientCommunicator.

Ported: the control plane (copies of the framework-free modules), the
sync protocol with dropout repair, the async buffered protocol, the
hierarchical intra-silo tier (device fleets), the server, the client,
the scheduler and ``Consortium``, over the data plane (packing, pairwise
fp32 and integer masks, streaming sinks, compression, aggregation).
"""
from repro_torch.core.aggregation import (AGGREGATORS, aggregate,  # noqa: F401
                                          aggregate_packed)
from repro_torch.core.client import (ClientAgent, ClientConfig,  # noqa: F401
                                     FLClientNode, OversubscribedError)
from repro_torch.core.clients import ClientManagement  # noqa: F401
from repro_torch.core.communicator import (ClientCommunicator,  # noqa: F401
                                           MessageBoard, ServerCommunicator)
from repro_torch.core.compression import (SCHEMES, ErrorFeedback,  # noqa: F401
                                          reduce_compressed)
from repro_torch.core.governance import (DEFAULT_DECISIONS,  # noqa: F401
                                         GovernanceCockpit,
                                         GovernanceContract)
from repro_torch.core.jobs import FLJob, JobCreator  # noqa: F401
from repro_torch.core.metadata import MetadataStore  # noqa: F401
from repro_torch.core.packing import (PackedLayout, pack_many,  # noqa: F401
                                      pack_pytree, unpack_pytree)
from repro_torch.core.protocol import (PROTOCOLS, AsyncBuffProtocol,  # noqa: F401
                                       Phase, Protocol, SyncProtocol,
                                       WakeCondition, make_protocol,
                                       staleness_weight)
from repro_torch.core.scheduler import (FederationScheduler,  # noqa: F401
                                        JobEntry)
from repro_torch.core.server import FLServer, ModelStore  # noqa: F401
from repro_torch.core.simulation import Consortium  # noqa: F401
from repro_torch.core.streaming import (MaskedF32Sink,  # noqa: F401
                                        ModularSink, QuantSink, TopkSink,
                                        stream_masked_packed)
from repro_torch.core.telemetry import (Counter, Gauge,  # noqa: F401
                                        Histogram, MetricsRegistry, Span,
                                        Telemetry)
from repro_torch.core.transport import (InProcTransport,  # noqa: F401
                                        SocketTransport,
                                        SocketTransportServer, Transport,
                                        WanModel, make_transport)
from repro_torch.core.validation import (DataSchema,  # noqa: F401
                                         ValidationResult, validate_stats)
