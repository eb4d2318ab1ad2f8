from repro_torch.data.federated import (  # noqa: F401
    dirichlet_partition, iid_partition, select_clients, stack_clients)
from repro_torch.data.synthetic import (  # noqa: F401
    DATASETS, synthetic_image_dataset, synthetic_lm_dataset)
