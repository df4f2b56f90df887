"""``mvsbench.serve_child`` with the forward's depth maps altered where they
are produced (5 % deeper): the fault the scan cell's check must catch."""

import sys

from mvsbench import serve_child


def main(argv):
    from scene_3dreconstruction_mvsnet_tpu_torch.eval import depth_gen

    make = depth_gen.make_infer_step

    def altered(model, device):
        infer = make(model, device)

        def wrong(*args):
            out = infer(*args)
            return {**out, "depth": out["depth"] * 1.05}

        return wrong

    depth_gen.make_infer_step = altered
    serve_child.main(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
