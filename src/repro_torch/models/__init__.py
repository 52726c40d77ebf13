from repro_torch.models.transformer import (Model, build_model,  # noqa
                                            build_params)
