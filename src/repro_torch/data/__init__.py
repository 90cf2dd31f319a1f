from repro_torch.data.pipeline import DataConfig, SyntheticSource, TokenFileSource, make_source  # noqa: F401
from repro_torch.data.synthetic import SynthConfig, eval_ppl_batch, icl_eval_batch, lm_batch  # noqa: F401
