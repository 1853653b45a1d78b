"""graph_replay_share.wfc: the control steps that replayed the step's CUDA graph
(``steps.wfc.replay`` spans) over the steps (``steps.wfc.step`` root spans) in the traced
slice; 1 where every traced step replayed (the program's spans)."""
from benchmark.harness.spans import per_step


def read(run):
    return per_step('steps.wfc.step', ['steps.wfc.replay'], 'count')
