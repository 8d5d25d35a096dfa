from awm_tpu_torch.data.dataset import (
    BatchLoader,
    ConcatClips,
    OneSecClips,
    SyntheticClips,
    SyntheticMusicClips,
    split_indices,
)

__all__ = ["BatchLoader", "ConcatClips", "OneSecClips", "SyntheticClips", "SyntheticMusicClips",
           "split_indices"]
