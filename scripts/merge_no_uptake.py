"""Merge extra no-uptake geometry runs (/tmp/nu_extra/<g>/...) into the
committed examples/no_uptake_h0.02 combined CSV.

Sulcus rows from each extra run are appended (deduped on
width/depth/Pe); rectangle baseline rows are kept from the committed
artifact (identical solve, avoids churn).  Ratio columns in the extra
runs were computed against their own rect baselines, which match the
committed ones to ~1e-10, so rows merge consistently.
"""
import os
from glob import glob

import numpy as np
import pandas as pd

MAIN = ("examples/no_uptake_h0.02/Geometry Comparison Analysis/"
        "geometry_comparison_results.csv")


def main():
    df = pd.read_csv(MAIN)
    key = ["Domain", "Sulcus Width (mm)", "Sulcus Depth (mm)", "Peclet"]
    added = []
    for path in sorted(glob("/tmp/nu_extra/*/Geometry Comparison "
                            "Analysis/geometry_comparison_results.csv")):
        ex = pd.read_csv(path)
        ex = ex[ex["Domain"] == "sulcus"]
        for _, r in ex.iterrows():
            dup = ((df["Domain"] == "sulcus")
                   & np.isclose(df["Sulcus Width (mm)"],
                                r["Sulcus Width (mm)"])
                   & np.isclose(df["Sulcus Depth (mm)"],
                                r["Sulcus Depth (mm)"])
                   & np.isclose(df["Peclet"], r["Peclet"]))
            if not dup.any():
                added.append(r)
    if added:
        df = pd.concat([df, pd.DataFrame(added)], ignore_index=True)
        df = df.sort_values(key).reset_index(drop=True)
        df.to_csv(MAIN, index=False)
    print(f"merged {len(added)} new rows -> {MAIN} ({len(df)} total)")


if __name__ == "__main__":
    main()
