from repro_torch.data.synthetic import (SyntheticCorpus,  # noqa: F401
                                        make_batch, zipf_token_stream)
