"""Command-line interface: headless render + interactive console.

Replaces the Satellite app layer (/root/reference/satellite/src/App.cpp,
Console.cpp): the GL window/ImGui console is out of scope (headless per
SURVEY.md §2 #21-23), but every console command has an equivalent:

  load/reload -> ``terra render scene.obj`` / ``--config``
  step/loop   -> ``--spp`` / ``--passes`` progressive accumulation
  save        -> ``-o out.png`` (+ .hdr support)
  opt list/set/load/save -> ``--opt k=v``, ``--config``, ``--save-config``
  stats       -> ``--stats`` profiler report
  console     -> ``terra console`` interactive REPL with the same commands

Usage:
    python -m terra_tpu render scene.obj --spp 64 -o out.png
    python -m terra_tpu render --cornell --integrator direct-mis -o c.png
    python -m terra_tpu console [scene.obj]
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional

import numpy as np

from . import compile_cache, scenes
from .config import Config, find_config_file, load_config_file
from .film import Film, develop
from .profile import profiler
from .render import render
from .scene import Accelerator, commit
from .checkpoint import load_render_state, save_render_state

log = logging.getLogger("terra_tpu")


def _autoload_scene_config(cfg: Config) -> Optional[str]:
    """Per-scene ``<name>.config`` autoload (Scene.cpp:121-128): when a scene
    OBJ is selected, apply a config file named after it in the same
    directory. The scene path itself is pinned (a per-scene config cannot
    redirect to another scene). Returns the loaded path or None."""
    scene_path = cfg.get("scene")
    if not scene_path:
        return None
    p = os.path.splitext(scene_path)[0] + ".config"
    if not os.path.exists(p):
        return None
    log.info("loading per-scene config %s", p)
    load_config_file(p, cfg)
    cfg.set("scene", scene_path)
    return p


def _build_scene(cfg: Config, args):
    if getattr(args, "cornell", False) or not cfg.get("scene"):
        # honor the configured accelerator; default remains BRUTE (fastest
        # for a 36-tri scene) unless the user set one explicitly (via
        # --opt, a config file, or the console's `opt set`)
        accel = Accelerator.BRUTE
        if "render_accelerator" in cfg.explicit:
            accel = cfg.get("render_accelerator")
        scene = scenes.cornell_box(accelerator=accel, env_value=cfg.get("envmap_color"))
        cam = scenes.cornell_camera()
        return scene, cam
    from .io.obj import load_obj

    geom, mats, atlas = load_obj(cfg.get("scene"))
    scene = commit(
        geom, mats, textures=atlas,
        env_value=cfg.get("envmap_color"),
        accelerator=cfg.get("render_accelerator"),
        bvh_builder=cfg.get("render_bvh_builder"),
    )
    return scene, cfg.camera()


def _apply_opts(cfg: Config, pairs: List[str]):
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"--opt expects key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        try:
            cfg.set(k.strip(), v.strip())
        except KeyError:
            raise SystemExit(
                f"unknown option {k.strip()!r}; see `python -m terra_tpu opt-list`"
            )
        except (ValueError, TypeError) as e:  # bad value for a known option
            raise SystemExit(f"bad value for option {k.strip()!r}: {v.strip()!r} ({e})")


def cmd_render(args) -> int:
    cfg = Config()
    config_path = args.config or find_config_file()
    if config_path:
        log.info("loading config %s", config_path)
        load_config_file(config_path, cfg)
    if args.scene:
        cfg.set("scene", args.scene)
    _autoload_scene_config(cfg)  # before CLI flags so explicit flags win
    if args.width:
        cfg.set("width", str(args.width))
    if args.height:
        cfg.set("height", str(args.height))
    if args.spp:
        cfg.set("render_samples", str(args.spp))
    if args.bounces is not None:
        cfg.set("render_bounces", str(args.bounces))
    if args.integrator:
        cfg.set("render_integrator", args.integrator)
    _apply_opts(cfg, args.opt)

    scene, cam = _build_scene(cfg, args)
    opts = cfg.render_options()
    seed = int(cfg.get("seed"))

    film: Optional[Film] = None
    if args.resume and args.checkpoint:
        try:
            film, seed, _ = load_render_state(args.checkpoint)
            log.info("resumed %s at %d spp", args.checkpoint, int(np.asarray(film.samples).max()))
        except FileNotFoundError:
            log.info("no checkpoint at %s; starting fresh", args.checkpoint)

    import time as _time

    from .profile import device_trace, ray_count

    passes = max(args.passes, 1)
    with device_trace(getattr(args, "trace", None)):
        for i in range(passes):
            t0 = _time.perf_counter()
            with profiler.clock("render"):
                film = render(scene, cam, opts, seed=seed, film=film)
                film.acc.block_until_ready()
            dt = _time.perf_counter() - t0
            # nominal rays (upper bound: no early termination) per pass
            profiler.add_sample("render_mrays", ray_count(opts) / dt / 1e6)
            if args.checkpoint:
                save_render_state(args.checkpoint, film, seed)
            spp_done = int(np.asarray(film.samples).max())
            log.info("pass %d/%d done (%d spp total)", i + 1, passes, spp_done)
            # headless analogue of the reference's live progressive display
            # (Visualization.cpp:213-284): refresh the output image every N
            # passes so a long render is observable (and usable) mid-flight
            if (args.preview_every and args.output and (i + 1) % args.preview_every == 0
                    and (i + 1) < passes):
                from .io.image import save_image

                save_image(args.output,
                           np.asarray(develop(film, opts.tonemap, opts.manual_exposure, opts.gamma)))
                log.info("preview written to %s (%d spp)", args.output, spp_done)

    img = develop(film, opts.tonemap, opts.manual_exposure, opts.gamma)
    if args.output:
        from .io.image import save_image

        save_image(args.output, np.asarray(img))
        log.info("wrote %s", args.output)
    if args.save_config:
        cfg.save(args.save_config)
    if args.stats:
        # per-stage device timings (reference: render/trace/ray/ray-tri
        # profile targets, TerraPresets.h:54-60)
        from .profile import stage_breakdown

        stage_breakdown(scene, cam, opts, seed=seed)
        print(profiler.report())
    return 0


def cmd_opt_list(_args) -> int:
    for line in Config().describe():
        print(line)
    return 0


_CONSOLE_COMMANDS = [
    "clear", "exit", "help", "load", "loop", "mesh", "opt", "pause",
    "quit", "reload", "resize", "save", "stats", "step",
]


def _poll_pause() -> bool:
    """Non-blocking check for a 'pause' line typed during `loop` (the
    reference's pause command stops its renderer between tile-job pushes,
    App.cpp:30-49 / Renderer.cpp:165-202; the synchronous equivalent
    polls stdin between progressive passes). Any other mid-loop input is
    reported and ignored."""
    import select

    try:
        while select.select([sys.stdin], [], [], 0)[0]:
            line = sys.stdin.readline()
            if not line:  # EOF mid-loop: treat as pause
                return True
            line = line.strip()
            if line == "pause":
                return True  # later buffered lines stay for the console
            if line:
                print(f"(ignored {line!r} during loop — only 'pause' "
                      "interrupts)")
    except (OSError, ValueError):
        return False
    return False
_CONSOLE_SUBCOMMANDS = {
    "opt": ["list", "load", "reset", "save", "set"],
    "mesh": ["list", "move"],
}


def _setup_readline():
    """Command history + tab completion for the console — the reference
    console's history/completion (Console.cpp). No-op without readline."""
    try:
        import readline
    except ImportError:
        return
    import atexit

    histfile = os.path.expanduser("~/.terra_tpu_history")
    try:
        readline.read_history_file(histfile)
    except OSError:
        pass
    atexit.register(lambda: _write_history(readline, histfile))

    def completer(text, state):
        buf = readline.get_line_buffer()
        parts = buf.split()
        at_first = len(parts) == 0 or (len(parts) == 1 and not buf.endswith(" "))
        if at_first:
            options = [c + " " for c in _CONSOLE_COMMANDS if c.startswith(text)]
        elif parts[0] in _CONSOLE_SUBCOMMANDS:
            options = [
                s + " " for s in _CONSOLE_SUBCOMMANDS[parts[0]] if s.startswith(text)
            ]
        else:
            options = []
        return options[state] if state < len(options) else None

    readline.set_completer(completer)
    readline.parse_and_bind("tab: complete")


def _write_history(readline_mod, histfile):
    try:
        readline_mod.set_history_length(1000)
        readline_mod.write_history_file(histfile)
    except OSError:
        pass


def cmd_console(args) -> int:
    """Interactive console with the reference's command set
    (App.cpp:30-49): clear help load reload step loop(passes) save opt
    resize stats — plus readline history and tab completion
    (Console.cpp's terminal niceties)."""
    cfg = Config()
    if args.scene:
        cfg.set("scene", args.scene)
        _autoload_scene_config(cfg)
    scene, cam = (None, None)
    film: Optional[Film] = None
    seed = 0
    _setup_readline()

    def ensure_scene():
        nonlocal scene, cam
        if scene is None:
            scene, cam = _build_scene(cfg, args)
        return scene, cam

    print("terra_tpu console — 'help' for commands, 'exit' to quit")
    while True:
        try:
            line = input("terra> ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if not line:
            continue
        parts = line.split()
        cmd, rest = parts[0], parts[1:]
        try:
            if cmd in ("exit", "quit"):
                return 0
            elif cmd == "help":
                print("commands: load <obj> | reload | step | loop [n] | pause | save <path> | "
                      "opt list | opt set <k> <v> | opt load <path> | opt save <path> | "
                      "resize <w> <h> | stats | clear | exit")
            elif cmd == "load":
                if rest:
                    cfg.set("scene", rest[0])
                    _autoload_scene_config(cfg)
                scene = None
                ensure_scene()
                film = None
                print("loaded", cfg.get("scene") or "cornell")
            elif cmd == "reload":
                scene = None
                ensure_scene()
                print("reloaded")
            elif cmd == "pause":
                # Outside a running loop there is nothing to pause: renders
                # are synchronous here (the reference pauses its async tile
                # renderer between job pushes, Renderer.cpp:165-202; our
                # equivalent interrupts `loop` between passes).
                print("nothing running — 'pause' interrupts a running 'loop'")
            elif cmd in ("step", "loop"):
                # `loop` with no count runs until `pause` (typed mid-loop)
                # or Ctrl-C — the reference's loop/pause pair (App.cpp:30-49
                # loop re-pushes every iteration until pause flips the
                # renderer state, Renderer.cpp:180-202).
                n = (int(rest[0]) if rest else None) if cmd == "loop" else 1
                s, c = ensure_scene()
                opts = cfg.render_options()
                i = 0
                try:
                    while n is None or i < n:
                        with profiler.clock("render"):
                            film = render(s, c, opts, seed=seed, film=film)
                            film.acc.block_until_ready()
                        i += 1
                        if _poll_pause():
                            print(f"paused after {i} passes")
                            break
                except KeyboardInterrupt:
                    print(f"\npaused after {i} passes")
                print(f"{int(np.asarray(film.samples).max())} spp accumulated")
            elif cmd == "save":
                if film is None:
                    print("nothing rendered")
                    continue
                from .io.image import save_image

                opts = cfg.render_options()
                save_image(rest[0], np.asarray(develop(film, opts.tonemap, opts.manual_exposure, opts.gamma)))
                print("wrote", rest[0])
            elif cmd == "opt":
                sub = rest[0] if rest else "list"
                if sub == "list":
                    print("\n".join(cfg.describe()))
                elif sub == "set":
                    before = cfg.scene_state()
                    cfg.set(rest[1], " ".join(rest[2:]))
                    film = None  # render-range options clear the film (App.cpp:619)
                    if cfg.scene_state() != before:
                        # scene-affecting option: re-commit on next use, the
                        # reference's diff propagation (App.cpp:663-672 ->
                        # Scene.cpp:426-454) — no explicit `reload` needed
                        scene = None
                elif sub == "load":
                    before = cfg.scene_state()
                    load_config_file(rest[1], cfg)
                    film = None
                    if cfg.scene_state() != before:
                        scene = None
                elif sub == "save":
                    cfg.save(rest[1])
                elif sub == "reset":
                    before = cfg.scene_state()
                    cfg = Config()
                    film = None
                    if cfg.scene_state() != before:
                        scene = None
            elif cmd == "resize":
                cfg.set("width", rest[0])
                cfg.set("height", rest[1])
                film = None
            elif cmd == "mesh":
                from . import edit

                s, _ = ensure_scene()
                sub = rest[0] if rest else "list"
                if sub == "list":
                    for obj in edit.list_objects(s):
                        print(f"  object {obj['object_id']:4d}: {obj['triangles']} tris "
                              f"bbox {obj['bbox_min']} .. {obj['bbox_max']}")
                elif sub == "move":
                    oid = int(rest[1])
                    delta = tuple(float(x) for x in rest[2:5])
                    scene = edit.move_object(s, oid, delta)
                    film = None
                    print(f"moved object {oid} by {delta}")
            elif cmd == "stats":
                print(profiler.report() or "(no samples)")
            elif cmd == "clear":
                film = None
            else:
                print(f"unknown command {cmd!r}; try 'help'")
        except Exception as e:  # console must not die on bad input
            print(f"error: {e}")


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="[%(levelname).1s] %(message)s")
    compile_cache.enable()
    p = argparse.ArgumentParser(prog="terra_tpu", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("render", help="render a scene to an image")
    pr.add_argument("scene", nargs="?", help="OBJ scene path")
    pr.add_argument("--cornell", action="store_true", help="use the built-in Cornell box")
    pr.add_argument("-o", "--output", help="output image (.png/.jpg/.hdr)")
    pr.add_argument("--width", type=int)
    pr.add_argument("--height", type=int)
    pr.add_argument("--spp", type=int, help="samples per pixel per pass")
    pr.add_argument("--bounces", type=int)
    pr.add_argument("--integrator", help="simple|direct|direct-mis|debug-*")
    pr.add_argument("--passes", type=int, default=1, help="progressive passes (the reference's loop)")
    pr.add_argument("--preview-every", type=int, default=0, metavar="N",
                    help="rewrite the output image every N passes (progressive preview)")
    pr.add_argument("--config", help="config file (default: search satellite.config)")
    pr.add_argument("--save-config", help="write effective options to file")
    pr.add_argument("--opt", action="append", metavar="K=V", help="set any registry option")
    pr.add_argument("--checkpoint", help="render-state checkpoint path (.npz)")
    pr.add_argument("--resume", action="store_true", help="resume from checkpoint if present")
    pr.add_argument("--stats", action="store_true", help="print profiler stats")
    pr.add_argument("--trace", metavar="DIR", default=None,
                    help="record a jax.profiler device trace into DIR")
    pr.set_defaults(func=cmd_render)

    po = sub.add_parser("opt-list", help="list all options")
    po.set_defaults(func=cmd_opt_list)

    pc = sub.add_parser("console", help="interactive console")
    pc.add_argument("scene", nargs="?")
    pc.add_argument("--cornell", action="store_true")
    pc.set_defaults(func=cmd_console)

    args = p.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
