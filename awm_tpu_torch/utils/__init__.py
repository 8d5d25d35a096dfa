from awm_tpu_torch.utils.audio_io import load_audio, load_mono_16k, resample, save_wav, to_mono

__all__ = ["load_audio", "save_wav", "to_mono", "resample", "load_mono_16k"]
