from ray_tpu_torch.dag.node import (  # noqa: F401
    ClassNode,
    DAGNode,
    FunctionNode,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.dag.compiled import CompiledDAG, CompiledDAGRef  # noqa: F401
