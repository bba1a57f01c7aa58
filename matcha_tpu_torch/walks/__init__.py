from matcha_tpu_torch.walks.alias import AliasTables, build_alias_tables  # noqa: F401
from matcha_tpu_torch.walks.clique import clique_node2vec_walks  # noqa: F401
from matcha_tpu_torch.walks.hyper import hypergraph_walks  # noqa: F401
from matcha_tpu_torch.walks.skipgram import train_skipgram  # noqa: F401
