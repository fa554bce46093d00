"""The paper's own case study (§IV): 2D cardiac cine, 16 frames of
160x160, 8 coils, complex64 K-space + sensitivity maps."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class MRIReconConfig:
    frames: int = 16
    coils: int = 8
    height: int = 160
    width: int = 160


CONFIG = MRIReconConfig()
SMOKE = MRIReconConfig(frames=2, coils=3, height=24, width=20)
