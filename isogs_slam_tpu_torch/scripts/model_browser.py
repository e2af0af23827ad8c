"""Experiment / model browser: a tkinter GUI over `experiments/`
(counterpart of isogs_slam_tpu/scripts/model_browser.py).

Lists every run directory with checkpoints, shows its eval summary, and
launches this package's viewer and extractors on the selected run. Falls
back to a text listing when tkinter or a display is unavailable (headless
hosts, the card machine among them).

    python -m isogs_slam_tpu_torch.scripts.model_browser [--root experiments]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from ..io.checkpoints import list_checkpoints


def scan_runs(root: str):
    """[(run_dir, n_checkpoints, latest_frame, summary dict|None)]"""
    runs = []
    for group in sorted(os.listdir(root)) if os.path.isdir(root) else []:
        gdir = os.path.join(root, group)
        if not os.path.isdir(gdir):
            continue
        for run in sorted(os.listdir(gdir)):
            rdir = os.path.join(gdir, run)
            cks = list_checkpoints(rdir)
            if not cks and not os.path.exists(
                    os.path.join(rdir, "params.npz")):
                continue
            summary = None
            sp = os.path.join(rdir, "eval", "eval_summary.json")
            if os.path.exists(sp):
                try:
                    with open(sp) as f:
                        summary = json.load(f)
                except json.JSONDecodeError:
                    pass
            runs.append((rdir, len(cks), cks[-1][0] if cks else None,
                         summary))
    return runs


def text_listing(root: str):
    runs = scan_runs(root)
    if not runs:
        print(f"no runs with checkpoints under {root}/")
        return
    print(f"{'run':50s} {'ckpts':>5s} {'latest':>7s}  eval")
    for rdir, n, latest, summary in runs:
        s = ""
        if summary:
            s = (f"ATE {summary.get('Final Average ATE RMSE (cm)', 0):.2f}cm"
                 f" PSNR {summary.get('Average PSNR', 0):.2f}")
        print(f"{rdir:50s} {n:5d} {str(latest):>7s}  {s}")


def gui(root: str):  # pragma: no cover - needs a display
    import tkinter as tk
    from tkinter import messagebox, ttk

    win = tk.Tk()
    win.title("isogs_slam_tpu_torch model browser")
    win.geometry("900x500")
    cols = ("run", "ckpts", "latest", "ate", "psnr")
    tree = ttk.Treeview(win, columns=cols, show="headings")
    for c, w in zip(cols, (420, 60, 70, 90, 90)):
        tree.heading(c, text=c)
        tree.column(c, width=w)
    tree.pack(fill="both", expand=True)

    runs = scan_runs(root)
    for rdir, n, latest, summary in runs:
        ate = psnr = ""
        if summary:
            ate = f"{summary.get('Final Average ATE RMSE (cm)', 0):.2f}"
            psnr = f"{summary.get('Average PSNR', 0):.2f}"
        tree.insert("", "end", values=(rdir, n, latest, ate, psnr))

    def selected_run():
        sel = tree.selection()
        return tree.item(sel[0])["values"][0] if sel else None

    def launch(module, *extra):
        rdir = selected_run()
        if not rdir:
            return
        cfg = os.path.join(rdir, "config.py")
        if not os.path.exists(cfg):
            messagebox.showerror("missing", f"{cfg} not found")
            return
        subprocess.Popen([sys.executable, "-m", module, cfg, *extra])

    bar = tk.Frame(win)
    bar.pack(fill="x")
    tk.Button(bar, text="Render replay + orbit", command=lambda: launch(
        "isogs_slam_tpu_torch.viz_scripts.final_recon",
        "--orbit-frames", "36")).pack(side="left")
    tk.Button(bar, text="Extract mesh", command=lambda: launch(
        "isogs_slam_tpu_torch.scripts.extract_mesh_fast",
        "--no-show")).pack(side="left")
    tk.Button(bar, text="Export splat PLY", command=lambda: launch(
        "isogs_slam_tpu_torch.scripts.export_ply")).pack(side="left")
    win.mainloop()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", type=str, default="experiments")
    p.add_argument("--text", action="store_true",
                   help="force the text listing")
    args = p.parse_args(argv)
    if args.text or not os.environ.get("DISPLAY"):
        if not args.text:
            print("[browser] no display; text listing "
                  "(pass --text to silence this)")
        text_listing(args.root)
        return
    try:
        gui(args.root)
    except Exception as e:
        print(f"[browser] GUI unavailable ({e}); text listing")
        text_listing(args.root)


if __name__ == "__main__":
    main()
