from prosim_torch.ops.mlp import MLP  # noqa: F401
from prosim_torch.ops.fourier import FourierEmbeddingFix, FourierEmbedding  # noqa: F401
from prosim_torch.ops.pointnet import PointNetPolylineEncoder  # noqa: F401
from prosim_torch.ops.neighbors import neighbor_topk  # noqa: F401
from prosim_torch.ops.edge_attn import edge_attn_core  # noqa: F401
from prosim_torch.ops.attention import GatedNeighborAttention  # noqa: F401
