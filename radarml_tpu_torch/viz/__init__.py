from radarml_tpu_torch.viz.plots import CaptureView, DatasetBrowser, gen_pos_map, plot_dataset

__all__ = ["CaptureView", "DatasetBrowser", "gen_pos_map", "plot_dataset"]
