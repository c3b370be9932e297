"""A stand-in for ``repro_torch.cuda_graph.CudaGraph`` on the CPU,
for the tests of the decode graphs and the train graphs."""
import torch


def _tensors(out) -> list:
    """The tensors of a step's output: nested tuples, lists and dicts."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


class FakeGraph:
    """Stands in for ``CudaGraph`` on the CPU. A CUDA capture runs nothing
    on the card and the replay that follows it runs the step once; here
    the capture runs the step (its outputs are the graph's) and that
    first replay does nothing. Every later replay runs the captured
    function again (a decode cache is written in place) and writes its
    outputs into the captured ones, as a graph refills its output
    buffers: a value the function took from the host at capture shows
    in every replay."""

    device_type = "cpu"
    made = []

    def __init__(self, device, share=None):
        self.fn, self.out, self.fresh, self.replays = None, None, False, 0
        # as a CUDA graph, a pool of its own or ``share``'s, and no
        # reference to ``share``
        self.pool = share.pool if share is not None else object()
        FakeGraph.made.append(self)

    def capture(self, fn):
        self.fn, self.out, self.fresh = fn, fn(), True
        return self.out

    def replay(self):
        self.replays += 1
        if self.fresh:
            self.fresh = False
            return
        for dst, src in zip(_tensors(self.out), _tensors(self.fn())):
            if dst is not src:
                dst.copy_(src)
