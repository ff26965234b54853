"""Inpainting2DTrainer: 2D texture-image inpainting, the counterpart of
the concatenated layout of `stinet_tpu/trainers/inpainting2d.py` (the
reference's inpainting2d_trainer.py), with its two branches: STINet over
the loader's image grid graphs ("graph"), and the conv2d baseline Resnet2D
on the same batches as images ("2d"), with an optional conditional
PatchGAN (`use_gan`). The enabled arch picks the branch.

Both train on the masked-composite L1, mean(|where(mask > 0, out, color) -
color|) over the batch's num_graphs * img_size^2 pixels, plus total
variation with `use_total_variation`, and with `use_vgg` the VGG16 content
and style terms (`models/vgg.py`). Per-batch metrics: loss, l1, mse, psnr
(data range 2), graph_tv and graph_lap_var (0 on the 2d branch, as in JAX),
and LPIPS(alex) with `use_lpips`. Every `epochs_per_fid` epochs, FID of
predictions against the ground truth over the fixed train samples and over
the validation set, on InceptionV3 pool3 features of `images / 2 + 0.5`.
As in JAX, the train ground truth's statistics are meant to freeze after
the first pass, but freezing drops the buffers `num_samples` counts, so
each FID epoch takes a new ground-truth pass (ROADMAP.md, Queue 3).
Gradient accumulation and Adam go through `graph_common._TrainStep`;
checkpoints hold the model's state dict under "graph" or "2d" (and the
discriminator's under "discriminator"), the optimizer states and the
accumulation state, and resume.

The GAN step (`GanStep`, JAX's `_make_gan_step`): the discriminator
`define_D(7, ndf, "n_layers", n_layers_D, "instance")` scores the prior
cat(color * (1 - (mask > 0)), mask) beside the detached fake composite and
beside the real image and steps on (lf + lr) / 2 with its own Adam (no
accumulation); then the generator's loss against the UPDATED discriminator,
L1 + total variation + gan_loss_weight * gan_loss(D(prior, fake), real),
with no VGG term. Its metrics add loss_D_fake, loss_D_real, loss_G and the
discriminator's sigmoid accuracies. Validation runs the plain 2d eval step.

JAX's 2d step applies Resnet2D without a `batch_stats` collection and
without a dropout RNG, so it cannot train norm="batch" or use_dropout; the
port's trainer refuses both (the modules have them).

With `trainer.profile` (and not a dry run) an `utils/profiling.py:
EpochProfiler` traces the train steps the reference's schedule picks,
into `<log_dir>/profile`, stepped at the top of each train batch where
the JAX trainer steps its own; `train()` closes it at the end (JAX never
closes its profiler, so a window open at the end writes nothing there).

Perceptual nets fail closed, as the JAX trainer's do: `use_lpips`, FID or
`use_vgg` need a weights file (`lpips_weights`, `inception_weights`,
`vgg_weights`: torch state-dict files) or `allow_random_features`, and
random-feature scalars are tagged `*_random_features`.

The models run on an explicit `torch.device`, the card unless the caller
asks for the CPU; weights are drawn from `torch.Generator`s seeded from the
config's `seed` (the discriminator's from seed + 1). Batches reach the
device through `iter_placed`, and every step, LPIPS, VGG and Inception
forwards included, runs inside `full_f32_matmuls`. The JAX trainer's
parameter-template probe reads the first validation batch, which draws
nothing; where the validation loader has no batch it reads the first train
batch, which shuffles the train order and draws the batch's samples, and
the port reads it too (`_probe`), so its batches stay the JAX trainer's.

With the loader's `stacked_batching` (forced in a torch.distributed group
of more than one rank; one image a slice of a leading sample axis) the
graph branch runs its images one by one (`make_stacked_inpainting2d_steps`:
every image has the same pixel count, so the mean of the images' losses is
the batch's), and the 2d branch and the GAN take the slices as one batch of
images. Across ranks each rank holds its slice of the global batch: its
losses and metrics are its share of the global batch means, the gradients
(the discriminator's too) are summed over the ranks, and the discriminator
steps before the generator's loss, as in one process. `use_gan` is ignored
on the graph branch, as in JAX.
"""
import time

import numpy as np
import torch

import stinet_tpu_torch.data.imagegraph  # noqa: F401  (registers the loader)
from stinet_tpu_torch.core.registry import DATALOADERS, TRAINERS
from stinet_tpu_torch.metrics import MetricTracker
from stinet_tpu_torch.metrics import graph_metrics as gm
from stinet_tpu_torch.metrics.fid import FIDScoreCumulative
from stinet_tpu_torch.models.factory import (
    count_parameters, define_D, define_G)
from stinet_tpu_torch.models.gan_networks import gan_loss
from stinet_tpu_torch.models.losses import total_variation_loss
from stinet_tpu_torch.serving import full_f32_matmuls, resolve_device
from stinet_tpu_torch.trainers.base import SingleModelTrainer
from stinet_tpu_torch.graph.hierarchy import scene_of
from stinet_tpu_torch.trainers.graph_common import (
    CONCATENATED_REFUSAL, _TrainStep, build_optimizer, host_metrics,
    iter_placed, maybe_data_mesh, mesh_sum, replicate_to_mesh, set_lr,
    step_lr, vertex_mask)
from stinet_tpu_torch.trainers.inpainting3d import (
    _timed, check_nan_in_params)
from stinet_tpu_torch.utils.profiling import EpochProfiler


def _perceptual_terms(composite, color, vgg, vgg_weights, tv_weight):
    """The loss's VGG content and style terms (`vgg_weights` times a
    VGGLoss `vgg`'s) and total variation weighted `tv_weight`, on
    [B, s, s, 3] images; each term only where its module or weight is
    given."""
    extra = 0.0
    if vgg is not None:
        content, style = vgg(composite, color)
        extra = extra + vgg_weights[0] * content + vgg_weights[1] * style
    if tv_weight is not None:
        extra = extra + total_variation_loss(composite, tv_weight)
    return extra


def _graph_branch(model, img_size, lpips, lpips_tag, tv_weight, vgg,
                  vgg_weights, impl):
    """(loss_of, metrics_of) of the graph branch on a grid batch (one or
    more images a graph): loss_of(graph) -> (loss, composite rows);
    metrics_of(graph, loss, composite) -> the metric dict."""
    def images(flat):
        return flat.reshape(-1, img_size, img_size, flat.shape[-1])

    def loss_of(graph):
        out = model(graph, impl=impl)
        composite = torch.where(graph.mask > 0, out, graph.color)
        n = graph.num_graphs * img_size * img_size
        loss = (composite[:n] - graph.color[:n]).abs().mean()
        loss = loss + _perceptual_terms(
            images(composite[:n]), images(graph.color[:n]), vgg,
            vgg_weights, tv_weight)
        return loss, composite

    def metrics_of(graph, loss, composite):
        composite = composite.detach().to(torch.float32)
        lvl0 = graph.levels[0]
        vmask = vertex_mask(graph)
        out = {
            "loss": loss,
            "l1": gm.l1(composite, graph.color, vmask),
            "mse": gm.mse(composite, graph.color, vmask),
            "psnr": gm.psnr(composite, graph.color, vmask, data_range=2.0),
        }
        out["graph_tv"], out["graph_lap_var"] = gm.graph_tv_and_lap_var(
            composite, lvl0.edges, lvl0.num_vertices)
        if lpips is not None:
            n = graph.num_graphs * img_size * img_size
            out[lpips_tag] = lpips(images(composite[:n]),
                                   images(graph.color[:n])).mean()
        return out

    return loss_of, metrics_of


def make_inpainting2d_steps(model, optimizer, img_size, lpips=None,
                            lpips_tag="lpips", tv_weight=None, vgg=None,
                            vgg_weights=(0.03, 3000.0), impl=None,
                            accumulate=1):
    """(train_step, eval_step) of the graph branch over grid graphs
    already on the model's device. train_step(graph, lr) -> metrics, one
    optimizer step at `lr` every `accumulate` calls (`_TrainStep`);
    eval_step(graph) -> (metrics, composite rows) without gradients. The
    loss adds `_perceptual_terms` on the composite images; `lpips` (an
    LPIPS module) adds its batch mean to the metrics as `lpips_tag`."""
    loss_of, metrics_of = _graph_branch(model, img_size, lpips, lpips_tag,
                                        tv_weight, vgg, vgg_weights, impl)

    def eval_step(graph):
        model.eval()
        with full_f32_matmuls(), torch.no_grad():
            loss, composite = loss_of(graph)
            return metrics_of(graph, loss, composite), composite

    return (_TrainStep(model, optimizer, loss_of, accumulate, metrics_of),
            eval_step)


class _StackedImagesStep(_TrainStep):
    """The graph branch's step over a stacked batch: each image's forward
    and backward in turn, the gradient sum_b grad(loss_b) / B (B summed
    over the ranks of a data mesh first, the gradients after)."""

    def _backward(self, graph, lr):
        scenes = [scene_of(graph, i) for i in range(graph.x.shape[0])]
        b = mesh_sum(self.mesh, torch.tensor(float(len(scenes)),
                                             device=graph.x.device))
        held = self._grads.hold()
        lsum, composites = 0.0, []
        for g in scenes:
            loss, composite = self.loss_of(g)
            (loss / (b * self.accumulate)).backward()
            lsum = lsum + loss.detach()
            composites.append(composite.detach())
        self._grads.reduce(held)
        return mesh_sum(self.mesh, lsum) / b, torch.stack(composites)


def make_stacked_inpainting2d_steps(model, optimizer, img_size, lpips=None,
                                    lpips_tag="lpips", tv_weight=None,
                                    vgg=None, vgg_weights=(0.03, 3000.0),
                                    impl=None, accumulate=1, mesh=None):
    """(train_step, eval_step) of the graph branch over stacked grid
    graphs (one image a slice), the counterpart of JAX's
    `_make_stacked_graph_steps`: the images one by one, the loss the mean
    of their losses (each image has s^2 pixels, so it is the concatenated
    batch's), each metric the mean of the images' (PSNR and
    graph_lap_var pooled per image first, as in JAX); with a data `mesh`
    over every rank's images. eval_step(graph) -> (metrics, [B, V_pad, 3]
    composites)."""
    loss_of, scene_metrics = _graph_branch(
        model, img_size, lpips, lpips_tag, tv_weight, vgg, vgg_weights, impl)

    def metrics_of(graph, loss, composites):
        sums = {}
        for i in range(composites.shape[0]):
            for k, v in scene_metrics(scene_of(graph, i), loss,
                                      composites[i]).items():
                sums[k] = sums.get(k, 0.0) + v
        keys = [k for k in sums if k != "loss"]
        flat = mesh_sum(mesh, torch.stack(
            [sums[k].to(torch.float32) for k in keys]
            + [torch.tensor(float(composites.shape[0]),
                            device=composites.device)]))
        out = {"loss": loss}
        out.update({k: v / flat[-1] for k, v in zip(keys, flat[:-1])})
        return out

    def eval_step(graph):
        model.eval()
        with full_f32_matmuls(), torch.no_grad():
            terms = [loss_of(scene_of(graph, i))
                     for i in range(graph.x.shape[0])]
            b = mesh_sum(mesh, torch.tensor(float(len(terms)),
                                            device=graph.x.device))
            loss = mesh_sum(mesh, sum(l for l, _ in terms)) / b
            composites = torch.stack([c for _, c in terms])
            return metrics_of(graph, loss, composites), composites

    return (_StackedImagesStep(model, optimizer, loss_of, accumulate,
                               metrics_of, mesh), eval_step)


# --- the 2d branch -----------------------------------------------------------

def batch_images(graph, img_size):
    """(x, color, mask) of a grid batch as [B, s, s, C] images: its first
    num_graphs * img_size^2 rows, or each slice's first img_size^2 rows of
    a stacked batch."""
    n = img_size * img_size

    def images(t):
        rows = t[:, :n] if t.dim() == 3 else t[:graph.num_graphs * n]
        return rows.reshape(-1, img_size, img_size, t.shape[-1])
    return images(graph.x), images(graph.color), images(graph.mask)


def _nchw(images):
    return images.permute(0, 3, 1, 2)


def nhwc_forward(model, x):
    """A conv2d model's [B, s, s, C] output on [B, s, s, C] inputs (the
    models are NCHW)."""
    return model(_nchw(x)).permute(0, 2, 3, 1)


def image_metrics(composite, color, loss, lpips=None, lpips_tag="lpips",
                  mesh=None):
    """The 2d branch's metric dict from [B, s, s, 3] images (JAX's
    `_image_metrics_from`): psnr -10 log10(mse / 4 + 1e-8), graph_tv and
    graph_lap_var 0. With a data `mesh` the images are this rank's equal
    share of the global batch, `loss` this rank's share of the global
    loss: the means are summed over the ranks at their share, the psnr
    taken from the global mse."""
    mse = ((composite - color) ** 2).mean()
    l1 = (composite - color).abs().mean()
    lp = None if lpips is None else lpips(composite, color).mean()
    if mesh is not None:
        share = 1.0 / mesh.n_parts
        flat = mesh_sum(mesh, torch.stack(
            [loss, l1 * share, mse * share]
            + ([] if lp is None else [lp * share])))
        loss, l1, mse = flat[0], flat[1], flat[2]
        lp = None if lp is None else flat[3]
    zero = torch.zeros((), device=color.device)
    out = {"loss": loss, "l1": l1, "mse": mse,
           "psnr": -10.0 * torch.log10(mse / 4.0 + 1e-8),
           "graph_tv": zero, "graph_lap_var": zero}
    if lp is not None:
        out[lpips_tag] = lp
    return out


class GanStep(_TrainStep):
    """gan_step(graph, lr) -> metrics: the conditional PatchGAN's step of
    the 2d branch (module docstring). Each call steps the discriminator at
    `lr`, then takes the generator's loss and backward, which steps every
    `accumulate` calls as `_TrainStep`'s does. One generator forward
    serves both halves (JAX runs it twice on the same weights)."""

    def __init__(self, model, optimizer, disc, disc_optimizer, img_size,
                 gan_mode, gan_loss_weight, tv_weight, accumulate,
                 metrics_of, mesh=None):
        super().__init__(model, optimizer, None, accumulate, metrics_of,
                         mesh)
        self.disc, self.disc_optimizer = disc, disc_optimizer
        self.img_size, self.gan_mode = img_size, gan_mode
        self.gan_loss_weight, self.tv_weight = gan_loss_weight, tv_weight

    def generate(self, graph):
        """(fake composite, color, prior) images of the batch."""
        x, color, mask = batch_images(graph, self.img_size)
        fake = torch.where(mask > 0, nhwc_forward(self.model, x), color)
        prior = torch.cat([color * (mask <= 0).to(color.dtype), mask], -1)
        return fake, color, prior

    def score(self, prior, image):
        return self.disc(_nchw(torch.cat([prior, image], -1)))

    def disc_loss(self, fake, color, prior):
        """(loss, {its terms and accuracies}) of the discriminator on the
        detached fake and the real image."""
        pf = self.score(prior, fake.detach())
        pr = self.score(prior, color)
        lf = gan_loss(pf, False, self.gan_mode)
        lr_ = gan_loss(pr, True, self.gan_mode)
        with torch.no_grad():
            terms = {"loss_D_fake": lf.detach(), "loss_D_real": lr_.detach(),
                     "accuracy_D_fake": (1.0 - torch.sigmoid(pf)).mean(),
                     "accuracy_D_real": torch.sigmoid(pr).mean()}
        return (lf + lr_) * 0.5, terms

    def gen_loss(self, fake, color, prior):
        """(loss, its GAN term) of the generator against the current
        discriminator, whose parameters take no gradient."""
        self.disc.requires_grad_(False)
        lg = gan_loss(self.score(prior, fake), True, self.gan_mode)
        loss = (fake - color).abs().mean()
        if self.tv_weight is not None:
            loss = loss + total_variation_loss(fake, self.tv_weight)
        return loss + self.gan_loss_weight * lg, lg

    def _loss(self, graph, lr):
        fake, color, prior = self.generate(graph)
        self.disc.train()
        self.disc.requires_grad_(True)
        self.disc_optimizer.zero_grad(set_to_none=True)
        d_loss, terms = self.disc_loss(fake, color, prior)
        if self.mesh is not None:
            # this rank's share of the global batch mean; the
            # discriminator's gradients summed over the ranks
            d_loss = d_loss / self.mesh.n_parts
        d_loss.backward()
        if self.mesh is not None:
            self.mesh.all_reduce_grads(list(self.disc.parameters()))
        set_lr(self.disc_optimizer, lr)
        self.disc_optimizer.step()
        loss, lg = self.gen_loss(fake, color, prior)
        terms["loss_G"] = lg.detach()
        if self.mesh is not None:
            loss = loss / self.mesh.n_parts
        return loss, (fake, color, terms)


def make_resnet2d_steps(model, optimizer, img_size, lpips=None,
                        lpips_tag="lpips", tv_weight=None, vgg=None,
                        vgg_weights=(0.03, 3000.0), accumulate=1, disc=None,
                        disc_optimizer=None, gan_mode="lsgan",
                        gan_loss_weight=1e-3, mesh=None):
    """(train_step, eval_step) of the 2d branch over grid batches already
    on the model's device, concatenated or stacked (`batch_images`), as
    `make_inpainting2d_steps` but on the batch's images; eval_step's
    composite is [B, s, s, 3]. With `disc` (and its `disc_optimizer`),
    train_step is the `GanStep`. With a data `mesh` each rank's images are
    its equal share of the global batch: its loss and metrics are its
    share of the global means, which the ranks sum, as the gradients."""
    def loss_of(graph):
        x, color, mask = batch_images(graph, img_size)
        composite = torch.where(mask > 0, nhwc_forward(model, x), color)
        loss = (composite - color).abs().mean() + _perceptual_terms(
            composite, color, vgg, vgg_weights, tv_weight)
        if mesh is not None:
            loss = loss / mesh.n_parts
        return loss, composite

    def metrics_of(graph, loss, composite):
        _, color, _ = batch_images(graph, img_size)
        return image_metrics(composite.detach(), color, loss, lpips,
                             lpips_tag, mesh)

    def gan_metrics_of(graph, loss, aux):
        fake, color, terms = aux
        out = image_metrics(fake.detach(), color, loss, lpips, lpips_tag,
                            mesh)
        if mesh is not None:
            flat = mesh_sum(mesh, torch.stack(list(terms.values()))
                            / mesh.n_parts)
            terms = dict(zip(terms, flat))
        out.update(terms)
        return out

    def eval_step(graph):
        model.eval()
        with full_f32_matmuls(), torch.no_grad():
            loss, composite = loss_of(graph)
            return metrics_of(graph, loss, composite), composite

    if disc is None:
        return (_TrainStep(model, optimizer, loss_of, accumulate,
                           metrics_of, mesh), eval_step)
    return (GanStep(model, optimizer, disc, disc_optimizer, img_size,
                    gan_mode, gan_loss_weight, tv_weight, accumulate,
                    gan_metrics_of, mesh), eval_step)


def _refuse_what_jax_cannot_train(arch_args):
    """JAX's 2d step applies Resnet2D without a `batch_stats` collection or
    a dropout RNG, so it raises for norm="batch" and use_dropout (module
    docstring); the port adds neither to the trainer."""
    if arch_args.get("norm", "batch") == "batch":
        raise NotImplementedError(
            'the 2d branch trains no norm="batch" Resnet2D: the JAX '
            "trainer's 2d step has no batch_stats collection to update")
    if arch_args.get("use_dropout", False):
        raise NotImplementedError(
            "the 2d branch trains no Resnet2D with use_dropout: the JAX "
            "trainer's 2d step has no dropout RNG")


@TRAINERS.register("Inpainting2DTrainer")
class Inpainting2DTrainer(SingleModelTrainer):
    ARCHS = {"graph": "SurfaceTextureInpaintingNet", "2d": "Resnet2D"}

    def __init__(self, config, device=None, impl=None):
        super().__init__(config)
        logger = config.get_logger("train")
        archs = config["archs"]
        graph_enabled = archs.get(self.ARCHS["graph"], {}).get("enabled",
                                                               False)
        conv_enabled = archs.get(self.ARCHS["2d"], {}).get("enabled", False)
        if graph_enabled == conv_enabled:
            raise ValueError("Exactly one of SurfaceTextureInpaintingNet/"
                             "Resnet2D must be enabled")
        self.branch = "graph" if graph_enabled else "2d"
        self.MODEL_KEY = self.branch   # the checkpoint's key, as in JAX
        arch_args = archs[self.ARCHS[self.branch]]["args"]
        if self.branch == "2d":
            _refuse_what_jax_cannot_train(arch_args)
        self.device = resolve_device(
            device or getattr(config, "device", None) or "cuda")

        self.data_loader = config.init_obj_with_config(
            "data_loader", DATALOADERS)
        self._probe()
        self.img_size = config["data_loader"]["args"]["img_size"]

        tcfg = config["trainer"]
        self.use_gan = tcfg.get("use_gan", False) and self.branch == "2d"
        self.gan_mode = tcfg.get("gan_mode", "lsgan")
        self.gan_loss_weight = tcfg.get("gan_loss_weight", 1e-3)
        self.use_total_variation = tcfg.get("use_total_variation", False)
        self.total_variation_weight = tcfg.get("total_variation_weight", 1e-4)
        self.do_validation = tcfg.get("do_validation", True)
        self.batches_per_log = tcfg.get("batches_per_log", 1)
        self.allow_random_features = tcfg.get("allow_random_features", False)
        self.vgg_content_weight = tcfg.get("vgg_content_weight", 0.03)
        self.vgg_style_weight = tcfg.get("vgg_style_weight", 3000.0)
        self.vgg_loss = self._setup_vgg(tcfg) if tcfg.get(
            "use_vgg", False) else None
        self.visualize_samples = tcfg.get("visualize_samples", False)
        self.epochs_per_fid = tcfg.get("epochs_per_fid", 0)
        self.use_val_fid = tcfg.get("use_val_fid", False)
        self.use_train_fid = tcfg.get("use_train_fid", False)
        self._fid_tag = "fid"
        self._fid = self._setup_fid(tcfg) if (
            (self.use_val_fid or self.use_train_fid)
            and self.epochs_per_fid) else None
        self.lpips_tag = "lpips"
        self.lpips = self._setup_lpips(tcfg) if tcfg.get(
            "use_lpips", False) else None
        # the reference's torch.profiler wrap of the train epoch
        # (inpainting2d_trainer.py:319-325), where the JAX trainer builds
        # its own
        self.profiler = None
        if tcfg.get("profile", False) and not config.dry_run:
            self.profiler = EpochProfiler(config.log_dir / "profile")

        dl_args = config["data_loader"]["args"]
        self.num_accum = int(dl_args.get("num_cumulated_train_batches", 1))
        seed = config.get("seed", 123) or 123
        self.model = define_G(
            **arch_args,
            generator=torch.Generator().manual_seed(seed)).to(self.device)
        logger.info("Number of parameters in %s: %d", self.branch,
                    count_parameters(self.model))
        self.optimizer, self.base_lr = build_optimizer(
            self.model.parameters(), config["optimizer"])
        self.lr_fn = step_lr(self.base_lr, config.get("lr_scheduler", {}))
        tv_weight = (self.total_variation_weight
                     if self.use_total_variation else None)
        common = dict(
            lpips=self.lpips, lpips_tag=self.lpips_tag, tv_weight=tv_weight,
            vgg=self.vgg_loss,
            vgg_weights=(self.vgg_content_weight, self.vgg_style_weight),
            accumulate=self.num_accum)
        self.disc = self.disc_optimizer = None
        # the loader decides the layout, the trainer follows
        self._stacked = bool(getattr(self.data_loader, "stacked", False))
        self._mesh = maybe_data_mesh(config.config, self.device, logger)
        if self._mesh is not None and not self._stacked:
            raise NotImplementedError(CONCATENATED_REFUSAL)
        if self.branch == "graph":
            make_steps = (make_stacked_inpainting2d_steps if self._stacked
                          else make_inpainting2d_steps)
            if self._stacked:
                common["mesh"] = self._mesh
            self._train_step, self._eval_step = make_steps(
                self.model, self.optimizer, self.img_size, impl=impl,
                **common)
        else:
            if self.use_gan:
                self.disc = define_D(
                    input_nc=1 + 3 + 3, ndf=tcfg.get("ndf", 64),
                    netD="n_layers", n_layers_D=tcfg.get("n_layers_D", 5),
                    norm="instance",
                    generator=torch.Generator().manual_seed(seed + 1)
                ).to(self.device)
                self.disc_optimizer, _ = build_optimizer(
                    self.disc.parameters(), config["optimizer"])
            self._train_step, self._eval_step = make_resnet2d_steps(
                self.model, self.optimizer, self.img_size, disc=self.disc,
                disc_optimizer=self.disc_optimizer, gan_mode=self.gan_mode,
                gan_loss_weight=self.gan_loss_weight, mesh=self._mesh,
                **common)

        if config.resume is not None:
            self._resume_checkpoint(config.resume)
        for model, optimizer in self._checkpointed().values():
            replicate_to_mesh(self._mesh, model, optimizer)

        metrics = ["loss", "l1", "mse", "psnr", "graph_tv", "graph_lap_var"]
        if self.lpips is not None:
            metrics.append(self.lpips_tag)
        if self.use_gan:
            metrics += ["loss_D_fake", "loss_D_real", "loss_G"]
        self.train_metrics = MetricTracker(*metrics, writer=self.writer)
        self.valid_metrics = MetricTracker(*metrics, writer=self.writer)
        # per train epoch: {"epoch", "steps", "train_s", "wait_ms": the ms
        # each step waited for its batch}
        self.epoch_timings = []
        # per FID pass: {"epoch", "split", "features_s": eval steps and
        # Inception forwards up to the host copy, "distance_s": the host
        # statistics and Frechet distance}
        self.fid_timings = []

    def train(self):
        """The epoch loop; the profiler's open window, if any, is written
        at its end (JAX never closes its profiler)."""
        try:
            super().train()
        finally:
            if self.profiler is not None:
                self.profiler.close()

    def _probe(self):
        """Advance the loaders as the JAX trainer's parameter-template
        probe does: it reads the first validation batch (no draws), or,
        where there is none, the first train batch."""
        for loader in (self.data_loader.val_loader,
                       self.data_loader.train_loader):
            if len(loader):
                if loader is self.data_loader.train_loader:
                    next(iter(loader))
                return
        raise RuntimeError("No data available")

    def _checkpointed(self):
        parts = super()._checkpointed()
        if self.disc is not None:
            parts["discriminator"] = (self.disc, self.disc_optimizer)
        return parts

    # ------------------------------------------------------------------
    def _require_random_optin(self, what, key):
        """Fail closed: a perceptual net with random weights needs
        trainer.allow_random_features (its numbers look real otherwise)."""
        if not self.allow_random_features:
            raise ValueError(
                f"{what} is enabled but trainer.{key} is not set. Either "
                f"point trainer.{key} at a converted torch state-dict file, "
                "or explicitly set trainer.allow_random_features=true to "
                "run with randomly initialized features (emitted scalars "
                "will be tagged *_random_features).")
        self.logger.warning(
            "%s running with RANDOM features (trainer.%s not set): values "
            "are relative trends only, tagged *_random_features", what, key)

    def _setup_vgg(self, tcfg):
        from stinet_tpu_torch.models.vgg import (
            VGGLoss, random_vgg, vgg_from_file)
        path = tcfg.get("vgg_weights")
        if path:
            vgg = vgg_from_file(path)
        else:
            self._require_random_optin("use_vgg", "vgg_weights")
            vgg = random_vgg(torch.Generator().manual_seed(0))
        return VGGLoss(vgg, resize_to=int(tcfg.get("vgg_resize", 224))).to(
            self.device)

    def _setup_fid(self, tcfg):
        from stinet_tpu_torch.models.inception import (
            InceptionV3, inception_from_file)
        path = tcfg.get("inception_weights")
        if path:
            model = inception_from_file(path)
        else:
            self._require_random_optin("FID", "inception_weights")
            self._fid_tag = "fid_random_features"
            model = InceptionV3(generator=torch.Generator().manual_seed(0))
        self.inception = model.to(self.device)

        def features(imgs):
            with full_f32_matmuls(), torch.no_grad():
                return self.inception(imgs / 2.0 + 0.5)
        return FIDScoreCumulative(feature_fn=features)

    def _setup_lpips(self, tcfg):
        from stinet_tpu_torch.metrics.lpips import (
            lpips_from_file, random_lpips)
        path = tcfg.get("lpips_weights")
        if path:
            return lpips_from_file(path).to(self.device)
        self._require_random_optin("use_lpips", "lpips_weights")
        self.lpips_tag = "lpips_random_features"
        return random_lpips(torch.Generator().manual_seed(0)).to(self.device)

    def _images(self, t, n_images):
        """This rank's [n_images, s, s, C] images from the first rows of a
        [V_pad, C] leaf, each slice's first rows of a stacked [B, V_pad, C]
        leaf, or the 2d branch's [B, s, s, C] images (JAX's
        `_local_images`)."""
        if t.dim() == 4:
            return t[:n_images]
        s = self.img_size
        if t.dim() == 3:
            return t[:n_images, :s * s].reshape(n_images, s, s, -1)
        return t[:n_images * s * s].reshape(n_images, s, s, -1)

    # ------------------------------------------------------------------
    def _train_epoch(self, epoch):
        check_nan_in_params(self.model, self.logger)
        self.train_metrics.reset()
        lr = self.lr_fn(epoch)
        loader = self.data_loader.train_loader
        len_epoch = len(loader)
        waits, steps = [], 0
        t0 = time.perf_counter()
        for batch_idx, (graph, names) in enumerate(_timed(
                iter_placed(loader, self.device), waits)):
            self.writer.set_step((epoch - 1) * len_epoch + batch_idx)
            if self.profiler is not None:
                self.profiler.step()
            m = host_metrics(self._train_step(graph, lr))
            for k, v in m.items():
                self.train_metrics.update(k, v)
            steps += 1
            if batch_idx % self.batches_per_log == 0:
                self.logger.debug(
                    ":Train Epoch: %s %s I Loss: %.6f", epoch,
                    self._progress(batch_idx, len_epoch), m["loss"])
        self.epoch_timings.append({
            "epoch": epoch, "steps": steps,
            "train_s": time.perf_counter() - t0, "wait_ms": waits})

        self.writer.set_step(epoch - 1, "epoch_train", quiet=True)
        log = self.train_metrics.result(write=True)
        log["lr"] = float(lr)
        if (self._fid is not None and self.use_train_fid
                and epoch % self.epochs_per_fid == 0):
            log["train_" + self._fid_tag] = self._train_fid(epoch)
        if self.do_validation:
            val_log = self._valid_epoch(epoch)
            log.update(**{"val_" + k: v for k, v in val_log.items()})
        return log

    def _fid_distance(self, epoch, split, key1, key2, t0):
        t1 = time.perf_counter()
        fid = self._fid.fid_between(key1, key2)
        self.fid_timings.append({
            "epoch": epoch, "split": split, "features_s": t1 - t0,
            "distance_s": time.perf_counter() - t1})
        return fid

    def _train_fid(self, epoch):
        """FID of predictions against the ground truth over the fixed train
        samples; the ground truth's statistics are frozen after the first
        pass."""
        t0 = time.perf_counter()
        self._fid.reset("train_pred")
        first = self._fid.num_samples("train_gt") == 0
        for graph, names in iter_placed(
                self.data_loader.sample_train_loader, self.device):
            _, composite = self._eval_step(graph)
            self._fid.add_images("train_pred",
                                 self._images(composite, len(names)))
            if first:
                self._fid.add_images("train_gt",
                                     self._images(graph.color, len(names)))
        if first:
            self._fid.freeze_statistics("train_gt")
        fid = self._fid_distance(epoch, "train", "train_gt", "train_pred", t0)
        self.writer.add_scalar("train_" + self._fid_tag, fid)
        return fid

    def _valid_epoch(self, epoch):
        t0 = time.perf_counter()
        self.valid_metrics.reset()
        fid_epoch = (self._fid is not None and epoch > 0
                     and epoch % self.epochs_per_fid == 0)
        if fid_epoch:
            self._fid.reset("val_pred")
        for batch_idx, (graph, names) in enumerate(
                iter_placed(self.data_loader.val_loader, self.device)):
            self.writer.set_step(batch_idx, "valid")
            metrics, composite = self._eval_step(graph)
            for k, v in host_metrics(metrics).items():
                self.valid_metrics.update(k, v)
            if fid_epoch:
                b = len(names)
                self._fid.add_images("val_pred", self._images(composite, b))
                if self._fid.num_samples("val_gt") < b * (batch_idx + 1):
                    self._fid.add_images("val_gt",
                                         self._images(graph.color, b))
        self.writer.set_step(epoch - 1, "epoch_valid", quiet=True)
        log = self.valid_metrics.result(write=True)
        if fid_epoch and self._fid.num_samples("val_pred"):
            log[self._fid_tag] = self._fid_distance(
                epoch, "val", "val_gt", "val_pred", t0)
            self.writer.add_scalar(self._fid_tag, log[self._fid_tag])
        if self.visualize_samples and self.writer.writer is not None:
            self._visualize_select_data()
        return log

    def _visualize_select_data(self):
        """Prediction grids of the fixed sample batches to TensorBoard."""
        from stinet_tpu_torch.utils.visualization_utils import (
            visualize_tensor)
        for tag, loader in (("sample_train",
                             self.data_loader.sample_train_loader),
                            ("sample_val",
                             self.data_loader.sample_val_loader)):
            preds = [self._images(self._eval_step(graph)[1],
                                  len(names)).cpu().numpy()
                     for graph, names in iter_placed(loader, self.device)]
            if preds:
                imgs = np.concatenate(preds)[:8] / 2.0 + 0.5
                visualize_tensor(self.writer, f"predictions_{tag}", imgs)

    def _eval(self, mode):
        log = self._valid_epoch(0)
        for key, value in log.items():
            self.logger.info("    %-15s: %s", str(key), value)
