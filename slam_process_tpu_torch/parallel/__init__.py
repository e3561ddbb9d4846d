from slam_process_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from slam_process_tpu_torch.parallel.batch import (  # noqa: F401
    batched_session_pipeline,
    run_dataset,
)
from slam_process_tpu_torch.parallel.streaming_device import (  # noqa: F401
    DeviceStreamingSession,
    make_paths_spec,
)
