from repro_torch.data.synthetic import DataConfig, SyntheticCorpus
from repro_torch.data.loader import PrefetchLoader
