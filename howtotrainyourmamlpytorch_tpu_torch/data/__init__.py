"""Episode data: the dataset registry, synthetic batches, the episodic
dataset and its prefetching loader (numpy only, copies of the JAX
package's ``data/``)."""

from . import synthetic  # noqa: F401
from .dataset import FewShotDataset  # noqa: F401
from .loader import MetaLearningDataLoader  # noqa: F401
from .registry import DatasetSpec, get_dataset_spec  # noqa: F401
