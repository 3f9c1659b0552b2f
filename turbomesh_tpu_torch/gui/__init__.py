"""Interactive mesh viewer window.

Reference parity: the desktop GUI front-end (src/gui/lib.zig:34-372,
src/gui/main.zig:60-128) — an OpenGL window drawing the mesh wireframe
with auto-fit camera, mouse-drag panning and zoom-at-cursor. Rebuilt on
matplotlib's interactive backend (no GL/GLFW dependency; the TPU
framework has no rendering hot path to accelerate):

- auto-fit camera on load (lib.zig:148-155: center = bbox center, scale
  fits the larger bbox extent with a margin);
- left-drag pans (lib.zig:321-344);
- scroll wheel zooms about the cursor position (lib.zig:346-372).

The reference's hot-reload dylib machinery (reload.zig) is dev-loop
tooling for compiled renderers and has no counterpart here — the viewer
is plain Python, already "hot" under importlib.reload.
"""

from __future__ import annotations

__all__ = ["view_mesh"]


def view_mesh(mesh, title: str = "turbomesh", block: bool = True):
    """Open an interactive wireframe window for a Mesh.

    Pan with left-drag, zoom at the cursor with the scroll wheel,
    press ``a`` to re-auto-fit, ``q`` to close.
    """
    import matplotlib

    try:
        import matplotlib.pyplot as plt

        fig = plt.figure(title, figsize=(11, 8))
    except Exception:  # headless fallback
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(title, figsize=(11, 8))
        block = False

    ax = fig.add_subplot(111)
    ax.set_aspect("equal")

    xmin = ymin = float("inf")
    xmax = ymax = float("-inf")
    for b in mesh.blocks:
        pts = b.points
        ax.plot(pts[:, :, 0], pts[:, :, 1], "-", color="#2060c0", lw=0.3)
        ax.plot(pts[:, :, 0].T, pts[:, :, 1].T, "-", color="#2060c0", lw=0.3)
        xmin = min(xmin, float(pts[..., 0].min()))
        xmax = max(xmax, float(pts[..., 0].max()))
        ymin = min(ymin, float(pts[..., 1].min()))
        ymax = max(ymax, float(pts[..., 1].max()))

    def auto_fit():
        # bbox center + 5% margin on the larger extent (lib.zig:148-155)
        dx, dy = xmax - xmin, ymax - ymin
        cx, cy = 0.5 * (xmin + xmax), 0.5 * (ymin + ymax)
        half = 0.5 * max(dx, dy) * 1.05 or 1.0
        ax.set_xlim(cx - half, cx + half)
        ax.set_ylim(cy - half, cy + half)
        fig.canvas.draw_idle()

    auto_fit()
    ax.set_title(f"{title} — {len(mesh.blocks)} blocks, "
                 f"{mesh.num_points} points (drag: pan, scroll: zoom, a: fit)")

    drag = {"xy": None}

    def on_press(ev):
        if ev.button == 1 and ev.inaxes is ax:
            drag["xy"] = (ev.xdata, ev.ydata)

    def on_release(_ev):
        drag["xy"] = None

    def on_move(ev):
        if drag["xy"] is None or ev.inaxes is not ax or ev.xdata is None:
            return
        x0, y0 = drag["xy"]
        dx, dy = ev.xdata - x0, ev.ydata - y0
        xl, xh = ax.get_xlim()
        yl, yh = ax.get_ylim()
        ax.set_xlim(xl - dx, xh - dx)
        ax.set_ylim(yl - dy, yh - dy)
        fig.canvas.draw_idle()

    def on_scroll(ev):
        if ev.inaxes is not ax or ev.xdata is None:
            return
        # zoom about the cursor: keep the data point under the cursor
        # fixed while scaling the view (lib.zig:346-372)
        factor = 0.9 if ev.button == "up" else 1.0 / 0.9
        xl, xh = ax.get_xlim()
        yl, yh = ax.get_ylim()
        ax.set_xlim(ev.xdata + (xl - ev.xdata) * factor,
                    ev.xdata + (xh - ev.xdata) * factor)
        ax.set_ylim(ev.ydata + (yl - ev.ydata) * factor,
                    ev.ydata + (yh - ev.ydata) * factor)
        fig.canvas.draw_idle()

    def on_key(ev):
        if ev.key == "a":
            auto_fit()
        elif ev.key == "q":
            import matplotlib.pyplot as plt

            plt.close(fig)

    fig.canvas.mpl_connect("button_press_event", on_press)
    fig.canvas.mpl_connect("button_release_event", on_release)
    fig.canvas.mpl_connect("motion_notify_event", on_move)
    fig.canvas.mpl_connect("scroll_event", on_scroll)
    fig.canvas.mpl_connect("key_press_event", on_key)

    if block:
        import matplotlib.pyplot as plt

        plt.show()
    return fig
