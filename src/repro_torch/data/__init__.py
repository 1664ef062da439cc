from repro_torch.data.datasets import (Dataset, iid_images, imbalanced_binary,
                                       shard_cluster, shard_iid, shard_noniid,
                                       tabular, text_tokens)

__all__ = ["Dataset", "iid_images", "imbalanced_binary", "shard_cluster",
           "shard_iid", "shard_noniid", "tabular", "text_tokens"]
