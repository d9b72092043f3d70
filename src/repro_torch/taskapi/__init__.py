from repro_torch.taskapi.artifacts import deserialize, package_pipeline, serialize, task_spec  # noqa
from repro_torch.taskapi.interfaces import Adapter, Decoder, Encoder, vFM  # noqa
from repro_torch.taskapi.modules import (IdentityEncoder,  # noqa
                                         LinearChannelCombiner, LinearDecoder,
                                         MLPDecoder)
from repro_torch.taskapi.pipeline import Pipeline  # noqa
