from repro_torch.controller.adaptation import AdaptResult, ElasticAdapter
from repro_torch.controller.maxshare import MaxShare, Plan
from repro_torch.controller.profiles import PAPER_PROFILES, get_profile
from repro_torch.controller.state import (ClusterState, Deployment, Server,
                                          TaskSpec)
