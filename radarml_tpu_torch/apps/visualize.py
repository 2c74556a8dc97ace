"""CLI: browse a captured dataset sample-by-sample.

Port of radarml_tpu/apps/visualize.py. Mirror of the reference's visualize.py entry point
(visualize.py:170-189): load a dataset pickle and open the keypress-
driven 3-projection browser (n=next, b=back, escape=quit). With
--out_png the first sample renders headless to a file instead (useful
over SSH / in CI).
"""

from __future__ import annotations

import argparse
import pickle

from radarml_tpu_torch.viz import DatasetBrowser


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", type=str,
                   default="datasets/radar_samples.pickle",
                   help="dataset name to visualize")
    p.add_argument("--out_png", type=str, default="",
                   help="render the first sample to a PNG and exit")
    p.add_argument("--index", type=int, default=0,
                   help="sample index for --out_png")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        with open(args.dataset, "rb") as fp:
            data = pickle.load(fp)
    except FileNotFoundError as e:
        raise SystemExit(f"error: {e}")

    samples, labels = data["samples"], data["labels"]
    if args.out_png:
        import matplotlib

        matplotlib.use("Agg")
        browser = DatasetBrowser(samples, labels)
        browser.idx = min(args.index, len(samples) - 1)
        browser._refresh()
        browser.fig.savefig(args.out_png)
        print(f"wrote {args.out_png} (sample {browser.idx}, "
              f'label "{labels[browser.idx]}")')
        return browser
    browser = DatasetBrowser(samples, labels)
    browser.show()
    return browser


if __name__ == "__main__":
    main()
