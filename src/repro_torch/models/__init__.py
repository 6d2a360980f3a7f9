"""The language-model stack: one config dataclass for all ten
architectures (:mod:`.config`), layer primitives (:mod:`.layers`),
RWKV6 and selective-SSM blocks (:mod:`.blocks`), the model assembly
(:mod:`.model`), the train / prefill / serve steps (:mod:`.steps`) and
the bridge from the reference package's parameter trees
(:mod:`.convert`).  Plain PyTorch: the stack holds no hand-written
kernel."""
