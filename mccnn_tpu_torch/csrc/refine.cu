// The main path's refinement chain: occlusion fill, mismatch fill, the
// subpixel parabola and the 5x5 median.
//
// The JAX package leaves these stages to XLA, which fuses each into one
// elementwise kernel on the TPU (mccnn_tpu/ops/post.py: interpolate_occlusion
// :68, interpolate_mismatch :122, subpixel_enhancement :215 and
// subpixel_enhancement_hwd :378, median2d :270). Eager PyTorch runs them as
// ~4,700 small launches a KITTI pair (ops/post.py's plain versions); these
// four kernels take their place, one launch a stage. Each selects, copies or
// compares values and accumulates nothing, so each is bit-identical to its
// plain version (ops/post.py, the *_plain functions):
//
// occlusion_fill: a block a row, each thread a run of OCC_V
//   adjacent columns in registers, loaded 8 bytes at a time where the rows
//   allow it. A thread finds its run's last and first MATCH; a warp's
//   ballot of the runs with one gives each lane the nearest such lane before
//   it (one shuffle fetches that run's last match), and the warp's last and
//   first match; the warps' own (a bit, two values each) meet in one small
//   shared array behind one barrier. An OCCLUSION pixel takes the value of
//   the last match at or left of it (its run's, an earlier lane's, an
//   earlier warp's, an earlier segment's), else of the row's first match
//   (there is then none left of it), else keeps its own; the run is stored
//   from registers. A row wider than the block's threads x OCC_V columns is
//   filled in segments, the last match carried from one to the next;
//   segments before the row's first match are revisited when it is found.
//   O(W) a row whatever the labels. Bound: 12 bytes a pixel (both maps
//   read, one written); what holds it is the launch and the chain of one
//   load, a ballot, three shuffles, a barrier and a store a block.
//
// mismatch_fill: a MISMATCH pixel walks each of the 16 rays (dx, dy) of
//   _RAY_DIRS: probe t = 1, 2, ... at (y + floor(t dy + 0.5),
//   x + floor(t dx + 0.5)). A probe out of frame lands empty, and so does one
//   of an odd t on row (column) 0 of a ray whose dy (dx) is -0.5: its true
//   coordinate is -0.5. A probe that is not MISMATCH lands with d0 there;
//   a MISMATCH probe walks on. Every ray has a component of +-1, so it leaves
//   the frame within max(H, W) steps: the plain version's pointer-doubling
//   rounds cover more, so both land on the same probes. The cnt landed values
//   give sorted[cnt / 2] through the plain version's selection network
//   (_median_network(16, 8): the invalid rays +-inf by rank), d0 if cnt is 0.
//   A probe's address does not depend on what an earlier probe loaded: only
//   where the walk stops does. So the probes of a ray go out together and
//   the first stop event among them decides. The first empty step t0 of a
//   ray is closed-form (first_out), so a probe is in frame iff t < t0.
//   A block takes a 32 x 8 tile: its pixels that are not MISMATCH copy d0,
//   its MISMATCH pixels are counted by ballots. A sparse tile (at most DENSE
//   of them) lists them in shared memory and its warps take one pixel each
//   in turn: in a round the rays still open share the 32 lanes (L = 32 / m
//   lanes for each of m rays), lane h of a ray probes t = base + h + L i for
//   i < P, all P loads issued before any compare; a ray's earliest event over
//   its lanes (a shared-memory atomicMin) closes it, the open ones go on at
//   base + L P. The landed d0 values load together and reach every lane by
//   shuffles. A dense tile walks a thread a pixel (neighbouring lanes probe
//   neighbouring addresses): each ray in chunks of Q probes in flight, the
//   16 landed values loaded together at the end. The work depends on the
//   data: a ray costs a load a probe. Bound: 12 bytes a pixel, or the probes
//   of the run's map at the instruction rate.
//
// subpixel: a thread a pixel; the three samples at d - 1, d, d + 1 read
//   through the volume's strides (the HWD lane's x-reversed (H, Wp, Dp), the
//   generic lane's (D, H, W) as its (H, W, D) view), f32, bf16 or f16 widened
//   to f32; the parabola with round-to-nearest intrinsics, so that no
//   contraction into an FMA moves a rounding (2 * (cp + cn - 2 * cz) as torch
//   computes it, an IEEE division, a clamp that keeps NaN). Bound: the map
//   read and written and three samples a pixel (20 bytes in f32). What holds
//   it on the HWD lane is the gather's fetches: each pixel's samples lie in a
//   column of their own (1 KB apart in f32), so each pixel costs a random
//   DRAM access whatever the kernel issues. One sample a pixel takes as long
//   as three, and a 16-byte vector read of the samples, with one to four
//   pixels a thread, was no faster (PERF.md).
//
// median5: a warp takes 32 x 8 outputs (MW such tiles a block) from a
//   shared-memory tile with a 2-pixel halo, its loads all issued before any
//   store, 8 bytes at a time where the rows allow it, and its NaN and -0.0
//   marked in a bit mask a tile row; a lane takes 2 x 4 adjacent outputs.
//   Two paths:
//   - fast, for a lane whose 6 x 8 window union lies in frame and holds no
//     NaN and no -0.0: its values are totally ordered and equal values have
//     equal bits, so every network that selects rank 12 of 25 returns the
//     same bits, and no +-inf fill or NaN rule is needed. MEDIAN5_FAST_NET
//     (ops/median_net.py) sorts the columns once for the outputs that share
//     them and merges the sorted lists, cut to the ranks rank 12 can still
//     use: 588 min/max for the 8 outputs, 73.5 a pixel against the plain
//     network's 226 (206 left after dead-code elimination);
//   - plain, for every other output (the lanes whose union leaves the frame
//     or holds a NaN or -0.0), shared out over the warp's 32 lanes: each
//     output's 25 taps in dx-outer order, the out-of-frame ones filled -inf
//     for the first 12 - cnt / 2 of them and +inf for the rest, then the
//     plain version's pruned network (_median_network(25, 12), 113
//     comparators) on torch.minimum / torch.maximum semantics: a NaN operand
//     (the first, if both are) is both results. A window without NaN takes
//     plain fminf / fmaxf.
//   Bound: 226 min/max a pixel at the instruction rate (3.1 us at KITTI
//   size; min.f32 and max.f32 issue at half that rate on the H100, PERF.md)
//   above its 8 bytes a pixel (1.1 us); the fast network's 73.5 a pixel take
//   1.0 us at the instruction rate, 2.0 at min.f32's.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr float MATCH = 0.f, OCCLUSION = 1.f, MISMATCH = 2.f;
constexpr int NT = 256;            // threads a block
constexpr int TX = 32, TY = 8;     // a block's outputs: 32 columns x 8 rows

constexpr int MX = 4;              // a median lane's outputs: 4 columns
constexpr int MY = 2;              // by 2 rows
constexpr int MW = 4;              // median: warps (32 x 8 tiles) a block
static_assert(TX / MX * (TY / MY) == 32 && MX % 2 == 0,
              "a median tile is one warp's");
constexpr int OCC_V = 4;           // occlusion: adjacent columns a thread
constexpr int OCC_MAX_NT = 1024;   // occlusion: the most threads a block

// The occlusion fill's threads a row for rows of W columns: runs of OCC_V
// columns in whole warps, at most OCC_MAX_NT a block (wider rows in segments).
constexpr int occlusion_threads(int W) {
  return (W + 32 * OCC_V - 1) / (32 * OCC_V) * 32 < OCC_MAX_NT
             ? (W + 32 * OCC_V - 1) / (32 * OCC_V) * 32
             : OCC_MAX_NT;
}

// _median_network(16, 8) of ops/post.py: 53 comparators
#define MEDIAN16_NET(C) \
  C(0, 1) C(2, 3) C(4, 5) C(6, 7) C(8, 9) C(10, 11) C(12, 13) C(14, 15) \
  C(0, 2) C(1, 3) C(4, 6) C(5, 7) C(8, 10) C(9, 11) C(12, 14) C(13, 15) \
  C(1, 2) C(5, 6) C(9, 10) C(13, 14) C(0, 4) C(1, 5) C(2, 6) C(3, 7) \
  C(8, 12) C(9, 13) C(10, 14) C(11, 15) C(2, 4) C(3, 5) C(10, 12) C(11, 13) \
  C(1, 2) C(3, 4) C(5, 6) C(9, 10) C(11, 12) C(13, 14) C(0, 8) C(1, 9) \
  C(2, 10) C(3, 11) C(4, 12) C(5, 13) C(6, 14) C(7, 15) C(4, 8) C(5, 9) \
  C(6, 10) C(7, 11) C(6, 8) C(7, 9) C(7, 8)

// _median_network(25, 12) of ops/post.py: 113 comparators
#define MEDIAN25_NET(C) \
  C(0, 1) C(2, 3) C(4, 5) C(6, 7) C(8, 9) C(10, 11) C(12, 13) C(14, 15) \
  C(16, 17) C(18, 19) C(20, 21) C(22, 23) C(0, 2) C(1, 3) C(4, 6) C(5, 7) \
  C(8, 10) C(9, 11) C(12, 14) C(13, 15) C(16, 18) C(17, 19) C(20, 22) \
  C(21, 23) C(1, 2) C(5, 6) C(9, 10) C(13, 14) C(17, 18) C(21, 22) C(0, 4) \
  C(1, 5) C(2, 6) C(3, 7) C(8, 12) C(9, 13) C(10, 14) C(11, 15) C(16, 20) \
  C(17, 21) C(18, 22) C(19, 23) C(2, 4) C(3, 5) C(10, 12) C(11, 13) \
  C(18, 20) C(19, 21) C(1, 2) C(3, 4) C(5, 6) C(9, 10) C(11, 12) C(13, 14) \
  C(17, 18) C(19, 20) C(21, 22) C(0, 8) C(1, 9) C(2, 10) C(3, 11) C(4, 12) \
  C(5, 13) C(6, 14) C(7, 15) C(16, 24) C(4, 8) C(5, 9) C(6, 10) C(7, 11) \
  C(20, 24) C(2, 4) C(3, 5) C(6, 8) C(7, 9) C(10, 12) C(11, 13) C(18, 20) \
  C(19, 21) C(22, 24) C(1, 2) C(3, 4) C(5, 6) C(7, 8) C(9, 10) C(11, 12) \
  C(13, 14) C(17, 18) C(19, 20) C(21, 22) C(23, 24) C(0, 16) C(1, 17) \
  C(2, 18) C(3, 19) C(4, 20) C(5, 21) C(6, 22) C(7, 23) C(8, 24) C(8, 16) \
  C(9, 17) C(10, 18) C(11, 19) C(12, 20) C(13, 21) C(6, 10) C(7, 11) \
  C(12, 16) C(13, 17) C(10, 12) C(11, 13) C(11, 12)

// The fast path's network for a lane's 2 x 4 outputs (ops/median_net.py
// prints it): value n < 48 is input I(n, r, c), row r and column c of the
// 6 x 8 window union; N(d, a, b) and X(d, a, b) the min and max of values a
// and b into value d; O(k, s) output k (row k / 4, column k % 4) is value s.
#define MEDIAN5_FAST_IN(I) \
  I(0, 0, 0) I(1, 0, 1) I(2, 0, 2) I(3, 0, 3) I(4, 0, 4) I(5, 0, 5) \
  I(6, 0, 6) I(7, 0, 7) I(8, 1, 0) I(9, 1, 1) I(10, 1, 2) I(11, 1, 3) \
  I(12, 1, 4) I(13, 1, 5) I(14, 1, 6) I(15, 1, 7) I(16, 2, 0) I(17, 2, 1) \
  I(18, 2, 2) I(19, 2, 3) I(20, 2, 4) I(21, 2, 5) I(22, 2, 6) I(23, 2, 7) \
  I(24, 3, 0) I(25, 3, 1) I(26, 3, 2) I(27, 3, 3) I(28, 3, 4) I(29, 3, 5) \
  I(30, 3, 6) I(31, 3, 7) I(32, 4, 0) I(33, 4, 1) I(34, 4, 2) I(35, 4, 3) \
  I(36, 4, 4) I(37, 4, 5) I(38, 4, 6) I(39, 4, 7) I(40, 5, 0) I(41, 5, 1) \
  I(42, 5, 2) I(43, 5, 3) I(44, 5, 4) I(45, 5, 5) I(46, 5, 6) I(47, 5, 7)
#define MEDIAN5_FAST_NET(N, X, O) \
  N(48, 9, 17) N(49, 25, 33) N(50, 48, 49) N(51, 1, 50) N(52, 10, 18) \
  N(53, 26, 34) N(54, 52, 53) N(55, 2, 54) X(56, 51, 55) X(57, 1, 50) \
  X(58, 48, 49) X(59, 9, 17) X(60, 25, 33) N(61, 59, 60) X(62, 58, 61) \
  X(63, 57, 62) X(64, 59, 60) X(65, 63, 64) X(66, 10, 18) X(67, 26, 34) \
  X(68, 66, 67) X(69, 2, 54) X(70, 52, 53) N(71, 66, 67) X(72, 70, 71) \
  X(73, 69, 72) X(74, 68, 73) N(75, 65, 74) N(76, 56, 75) N(77, 57, 62) \
  N(78, 58, 61) X(79, 77, 78) N(80, 69, 72) N(81, 70, 71) X(82, 80, 81) \
  N(83, 79, 82) N(84, 76, 83) N(85, 77, 78) N(86, 80, 81) N(87, 85, 86) \
  X(88, 84, 87) N(89, 11, 19) N(90, 27, 35) N(91, 89, 90) N(92, 3, 91) \
  N(93, 12, 20) N(94, 28, 36) N(95, 93, 94) N(96, 4, 95) X(97, 92, 96) \
  X(98, 11, 19) X(99, 27, 35) X(100, 98, 99) X(101, 3, 91) X(102, 89, 90) \
  N(103, 98, 99) X(104, 102, 103) X(105, 101, 104) X(106, 100, 105) \
  X(107, 12, 20) X(108, 28, 36) X(109, 107, 108) X(110, 4, 95) \
  X(111, 93, 94) N(112, 107, 108) X(113, 111, 112) X(114, 110, 113) \
  X(115, 109, 114) N(116, 106, 115) N(117, 97, 116) N(118, 101, 104) \
  N(119, 102, 103) X(120, 118, 119) N(121, 110, 113) N(122, 111, 112) \
  X(123, 121, 122) N(124, 120, 123) N(125, 117, 124) N(126, 118, 119) \
  N(127, 121, 122) N(128, 126, 127) X(129, 125, 128) X(130, 88, 129) \
  X(131, 85, 86) N(132, 63, 64) N(133, 68, 73) N(134, 132, 133) \
  X(135, 131, 134) X(136, 56, 75) X(137, 79, 82) N(138, 136, 137) \
  X(139, 135, 138) X(140, 126, 127) N(141, 100, 105) N(142, 109, 114) \
  N(143, 141, 142) X(144, 140, 143) X(145, 97, 116) X(146, 120, 123) \
  N(147, 145, 146) X(148, 144, 147) N(149, 139, 148) X(150, 130, 149) \
  X(151, 76, 83) N(152, 131, 134) X(153, 151, 152) X(154, 117, 124) \
  N(155, 140, 143) X(156, 154, 155) X(157, 153, 156) N(158, 51, 55) \
  N(159, 92, 96) X(160, 158, 159) X(161, 136, 137) X(162, 132, 133) \
  X(163, 161, 162) X(164, 145, 146) X(165, 141, 142) X(166, 164, 165) \
  N(167, 163, 166) X(168, 160, 167) N(169, 157, 168) X(170, 150, 169) \
  N(171, 151, 152) N(172, 154, 155) X(173, 171, 172) N(174, 161, 162) \
  N(175, 164, 165) N(176, 174, 175) X(177, 173, 176) N(178, 84, 87) \
  N(179, 125, 128) X(180, 178, 179) X(181, 65, 74) X(182, 106, 115) \
  N(183, 181, 182) X(184, 180, 183) N(185, 135, 138) N(186, 144, 147) \
  X(187, 185, 186) N(188, 184, 187) N(189, 177, 188) X(190, 170, 189) \
  N(191, 153, 156) N(192, 160, 167) X(193, 191, 192) N(194, 130, 149) \
  X(195, 193, 194) N(196, 180, 183) N(197, 185, 186) X(198, 196, 197) \
  N(199, 173, 176) N(200, 198, 199) X(201, 195, 200) N(202, 8, 16) \
  N(203, 24, 32) N(204, 202, 203) X(205, 0, 204) X(206, 202, 203) \
  X(207, 8, 16) X(208, 24, 32) N(209, 207, 208) X(210, 206, 209) \
  N(211, 205, 210) N(212, 206, 209) N(213, 211, 212) X(214, 201, 213) \
  N(215, 190, 214) X(216, 198, 199) N(217, 150, 169) X(218, 216, 217) \
  X(219, 205, 210) X(220, 207, 208) N(221, 219, 220) N(222, 218, 221) \
  X(223, 215, 222) N(224, 0, 204) N(225, 195, 200) X(226, 224, 225) \
  X(227, 219, 220) N(228, 170, 189) N(229, 227, 228) X(230, 226, 229) \
  X(231, 211, 212) N(232, 216, 217) X(233, 231, 232) N(234, 230, 233) \
  N(235, 223, 234) N(236, 13, 21) N(237, 29, 37) N(238, 236, 237) \
  X(239, 5, 238) X(240, 236, 237) X(241, 13, 21) X(242, 29, 37) \
  N(243, 241, 242) X(244, 240, 243) N(245, 239, 244) N(246, 240, 243) \
  N(247, 245, 246) X(248, 201, 247) N(249, 190, 248) X(250, 241, 242) \
  X(251, 239, 244) N(252, 250, 251) N(253, 218, 252) X(254, 249, 253) \
  N(255, 5, 238) X(256, 225, 255) X(257, 250, 251) N(258, 228, 257) \
  X(259, 256, 258) X(260, 245, 246) X(261, 232, 260) N(262, 259, 261) \
  N(263, 254, 262) N(264, 14, 22) N(265, 30, 38) N(266, 264, 265) \
  N(267, 6, 266) X(268, 255, 267) X(269, 14, 22) X(270, 30, 38) \
  X(271, 269, 270) X(272, 6, 266) X(273, 264, 265) N(274, 269, 270) \
  X(275, 273, 274) X(276, 272, 275) X(277, 271, 276) N(278, 257, 277) \
  N(279, 268, 278) N(280, 272, 275) N(281, 273, 274) X(282, 280, 281) \
  N(283, 260, 282) N(284, 279, 283) N(285, 280, 281) N(286, 247, 285) \
  X(287, 284, 286) X(288, 129, 287) X(289, 247, 285) N(290, 271, 276) \
  N(291, 252, 290) X(292, 289, 291) X(293, 268, 278) X(294, 260, 282) \
  N(295, 293, 294) X(296, 292, 295) N(297, 148, 296) X(298, 288, 297) \
  X(299, 279, 283) N(300, 289, 291) X(301, 299, 300) X(302, 156, 301) \
  N(303, 255, 267) X(304, 159, 303) X(305, 293, 294) X(306, 252, 290) \
  X(307, 305, 306) N(308, 166, 307) X(309, 304, 308) N(310, 302, 309) \
  X(311, 298, 310) N(312, 299, 300) X(313, 172, 312) N(314, 305, 306) \
  N(315, 175, 314) X(316, 313, 315) N(317, 284, 286) X(318, 179, 317) \
  X(319, 257, 277) N(320, 182, 319) X(321, 318, 320) N(322, 292, 295) \
  X(323, 186, 322) N(324, 321, 323) N(325, 316, 324) X(326, 311, 325) \
  N(327, 156, 301) N(328, 304, 308) X(329, 327, 328) N(330, 288, 297) \
  X(331, 329, 330) N(332, 318, 320) N(333, 186, 322) X(334, 332, 333) \
  N(335, 313, 315) N(336, 334, 335) X(337, 331, 336) X(338, 86, 337) \
  N(339, 326, 338) X(340, 334, 335) N(341, 298, 310) X(342, 340, 341) \
  N(343, 133, 342) X(344, 339, 343) N(345, 331, 336) X(346, 55, 345) \
  N(347, 311, 325) N(348, 74, 347) X(349, 346, 348) N(350, 340, 341) \
  X(351, 82, 350) N(352, 349, 351) N(353, 344, 352) N(354, 15, 23) \
  N(355, 31, 39) N(356, 354, 355) X(357, 7, 356) X(358, 354, 355) \
  X(359, 15, 23) X(360, 31, 39) N(361, 359, 360) X(362, 358, 361) \
  N(363, 357, 362) N(364, 358, 361) N(365, 363, 364) X(366, 337, 365) \
  N(367, 326, 366) X(368, 359, 360) X(369, 357, 362) N(370, 368, 369) \
  N(371, 342, 370) X(372, 367, 371) N(373, 7, 356) X(374, 345, 373) \
  X(375, 368, 369) N(376, 347, 375) X(377, 374, 376) X(378, 363, 364) \
  X(379, 350, 378) N(380, 377, 379) N(381, 372, 380) N(382, 41, 50) \
  N(383, 42, 54) X(384, 382, 383) X(385, 42, 54) X(386, 72, 385) \
  X(387, 68, 386) X(388, 41, 50) X(389, 62, 388) X(390, 64, 389) \
  N(391, 387, 390) N(392, 384, 391) N(393, 62, 388) X(394, 78, 393) \
  N(395, 72, 385) X(396, 81, 395) N(397, 394, 396) N(398, 392, 397) \
  N(399, 78, 393) N(400, 81, 395) N(401, 399, 400) X(402, 398, 401) \
  N(403, 43, 91) N(404, 44, 95) X(405, 403, 404) X(406, 43, 91) \
  X(407, 104, 406) X(408, 100, 407) X(409, 44, 95) X(410, 113, 409) \
  X(411, 109, 410) N(412, 408, 411) N(413, 405, 412) N(414, 104, 406) \
  X(415, 119, 414) N(416, 113, 409) X(417, 122, 416) N(418, 415, 417) \
  N(419, 413, 418) N(420, 119, 414) N(421, 122, 416) N(422, 420, 421) \
  X(423, 419, 422) X(424, 402, 423) X(425, 399, 400) N(426, 68, 386) \
  N(427, 64, 389) N(428, 426, 427) X(429, 425, 428) X(430, 384, 391) \
  X(431, 394, 396) N(432, 430, 431) X(433, 429, 432) X(434, 420, 421) \
  N(435, 100, 407) N(436, 109, 410) N(437, 435, 436) X(438, 434, 437) \
  X(439, 405, 412) X(440, 415, 417) N(441, 439, 440) X(442, 438, 441) \
  N(443, 433, 442) X(444, 424, 443) X(445, 392, 397) N(446, 425, 428) \
  X(447, 445, 446) X(448, 413, 418) N(449, 434, 437) X(450, 448, 449) \
  X(451, 447, 450) N(452, 382, 383) N(453, 403, 404) X(454, 452, 453) \
  X(455, 430, 431) X(456, 426, 427) X(457, 455, 456) X(458, 439, 440) \
  X(459, 435, 436) X(460, 458, 459) N(461, 457, 460) X(462, 454, 461) \
  N(463, 451, 462) X(464, 444, 463) N(465, 445, 446) N(466, 448, 449) \
  X(467, 465, 466) N(468, 455, 456) N(469, 458, 459) N(470, 468, 469) \
  X(471, 467, 470) N(472, 398, 401) N(473, 419, 422) X(474, 472, 473) \
  X(475, 387, 390) X(476, 408, 411) N(477, 475, 476) X(478, 474, 477) \
  N(479, 429, 432) N(480, 438, 441) X(481, 479, 480) N(482, 478, 481) \
  N(483, 471, 482) X(484, 464, 483) N(485, 447, 450) N(486, 454, 461) \
  X(487, 485, 486) N(488, 424, 443) X(489, 487, 488) N(490, 474, 477) \
  N(491, 479, 480) X(492, 490, 491) N(493, 467, 470) N(494, 492, 493) \
  X(495, 489, 494) X(496, 40, 204) N(497, 210, 496) N(498, 212, 497) \
  X(499, 495, 498) N(500, 484, 499) X(501, 492, 493) N(502, 444, 463) \
  X(503, 501, 502) X(504, 210, 496) N(505, 220, 504) N(506, 503, 505) \
  X(507, 500, 506) N(508, 40, 204) N(509, 489, 494) X(510, 508, 509) \
  X(511, 220, 504) N(512, 464, 483) N(513, 511, 512) X(514, 510, 513) \
  X(515, 212, 497) N(516, 501, 502) X(517, 515, 516) N(518, 514, 517) \
  N(519, 507, 518) X(520, 45, 238) N(521, 244, 520) N(522, 246, 521) \
  X(523, 495, 522) N(524, 484, 523) X(525, 244, 520) N(526, 250, 525) \
  N(527, 503, 526) X(528, 524, 527) N(529, 45, 238) X(530, 509, 529) \
  X(531, 250, 525) N(532, 512, 531) X(533, 530, 532) X(534, 246, 521) \
  X(535, 516, 534) N(536, 533, 535) N(537, 528, 536) N(538, 46, 266) \
  X(539, 529, 538) X(540, 46, 266) X(541, 275, 540) X(542, 271, 541) \
  N(543, 531, 542) N(544, 539, 543) N(545, 275, 540) X(546, 281, 545) \
  N(547, 534, 546) N(548, 544, 547) N(549, 281, 545) N(550, 522, 549) \
  X(551, 548, 550) X(552, 423, 551) X(553, 522, 549) N(554, 271, 541) \
  N(555, 526, 554) X(556, 553, 555) X(557, 539, 543) X(558, 534, 546) \
  N(559, 557, 558) X(560, 556, 559) N(561, 442, 560) X(562, 552, 561) \
  X(563, 544, 547) N(564, 553, 555) X(565, 563, 564) X(566, 450, 565) \
  N(567, 529, 538) X(568, 453, 567) X(569, 557, 558) X(570, 526, 554) \
  X(571, 569, 570) N(572, 460, 571) X(573, 568, 572) N(574, 566, 573) \
  X(575, 562, 574) N(576, 563, 564) X(577, 466, 576) N(578, 569, 570) \
  N(579, 469, 578) X(580, 577, 579) N(581, 548, 550) X(582, 473, 581) \
  X(583, 531, 542) N(584, 476, 583) X(585, 582, 584) N(586, 556, 559) \
  X(587, 480, 586) N(588, 585, 587) N(589, 580, 588) X(590, 575, 589) \
  N(591, 450, 565) N(592, 568, 572) X(593, 591, 592) N(594, 552, 561) \
  X(595, 593, 594) N(596, 582, 584) N(597, 480, 586) X(598, 596, 597) \
  N(599, 577, 579) N(600, 598, 599) X(601, 595, 600) X(602, 400, 601) \
  N(603, 590, 602) X(604, 598, 599) N(605, 562, 574) X(606, 604, 605) \
  N(607, 426, 606) X(608, 603, 607) N(609, 595, 600) X(610, 383, 609) \
  N(611, 575, 589) N(612, 387, 611) X(613, 610, 612) N(614, 604, 605) \
  X(615, 396, 614) N(616, 613, 615) N(617, 608, 616) X(618, 47, 356) \
  N(619, 362, 618) N(620, 364, 619) X(621, 601, 620) N(622, 590, 621) \
  X(623, 362, 618) N(624, 368, 623) N(625, 606, 624) X(626, 622, 625) \
  N(627, 47, 356) X(628, 609, 627) X(629, 368, 623) N(630, 611, 629) \
  X(631, 628, 630) X(632, 364, 619) X(633, 614, 632) N(634, 631, 633) \
  N(635, 626, 634) O(0, 235) O(1, 263) O(2, 353) O(3, 381) O(4, 519) \
  O(5, 537) O(6, 617) O(7, 635)

// The 16 rays of ops/post.py _RAY_DIRS, (dx, dy) as twice their value.
#define RAYS(R) \
  R(0, 0, 2) R(1, -1, 2) R(2, -2, 2) R(3, -2, 1) R(4, -2, 0) R(5, -2, -1) \
  R(6, -2, -2) R(7, -1, -2) R(8, 0, -2) R(9, 1, -2) R(10, 2, -2) \
  R(11, 2, -1) R(12, 2, 0) R(13, 2, 1) R(14, 2, 2) R(15, 1, 2)

// One comparator: (a, b) <- (torch.minimum(a, b), torch.maximum(a, b)).
// With NANS false the caller knows neither operand is NaN.
template <bool NANS>
__device__ __forceinline__ void order(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  if (NANS) {
    const bool an = a != a, any = an || b != b;
    const float n = an ? a : b;
    a = any ? n : lo;
    b = any ? n : hi;
  } else {
    a = lo;
    b = hi;
  }
}

template <bool NANS>
__device__ __forceinline__ float select_mid16(float (&v)[16]) {
#define CMP(i, j) order<NANS>(v[i], v[j]);
  MEDIAN16_NET(CMP)
#undef CMP
  return v[8];
}

template <bool NANS>
__device__ __forceinline__ float select_mid25(float (&v)[25]) {
#define CMP(i, j) order<NANS>(v[i], v[j]);
  MEDIAN25_NET(CMP)
#undef CMP
  return v[12];
}

// floor(t * C2 / 2 + 0.5) for a ray component C2 / 2 in {-1, -0.5, 0, 0.5, 1}
template <int C2>
__device__ __forceinline__ int ray_step(int t) {
  return C2 == 2 ? t : C2 == -2 ? -t : C2 == 1 ? (t + 1) >> 1
         : C2 == -1 ? -(t >> 1) : 0;
}

// The first step t >= 1 at which a ray component C2 / 2 of a walk from pos
// leaves [0, N), or is the -0.5 rule's odd step on 0 (C2 = -1: t = 2 pos + 1,
// whose coordinate floor(-t / 2 + 0.5) + pos is 0); no limit for 0.
__device__ __forceinline__ int first_out(int c2, int pos, int N) {
  return c2 == 2 ? N - pos : c2 == -2 ? pos + 1
         : c2 == 1 ? 2 * (N - 1 - pos) + 1 : c2 == -1 ? 2 * pos + 1
         : INT_MAX;
}

// The rays' components packed 3 bits a ray, C2 + 2, for a run-time ray index.
#define RAY_DX2(k, dx2, dy2) | (unsigned long long)((dx2) + 2) << (3 * (k))
#define RAY_DY2(k, dx2, dy2) | (unsigned long long)((dy2) + 2) << (3 * (k))
constexpr unsigned long long RAYS_DX2 = 0ull RAYS(RAY_DX2);
constexpr unsigned long long RAYS_DY2 = 0ull RAYS(RAY_DY2);
#undef RAY_DX2
#undef RAY_DY2

__device__ __forceinline__ int ray_c2(unsigned long long packed, int r) {
  return (int)((packed >> (3 * r)) & 7) - 2;
}

constexpr unsigned FULL = 0xffffffffu;
constexpr int NW = NT / 32;   // warps a block
constexpr int DENSE = 64;     // a tile with more MISMATCH pixels walks a
                              // thread a pixel
constexpr int P = 8;          // a sparse walk's probes a lane a round
constexpr int Q = 8;          // a dense walk's probes of a ray in flight

// sorted(landed)[cnt / 2] of the 16 rays, v[k] the value ray k landed on
// where bit k of `has` is set; v0 if none landed.
__device__ __forceinline__ float median_of_rays(float (&v)[16], unsigned has,
                                                float v0) {
  const int cnt = __popc(has);
  if (cnt == 0) return v0;
  const int a = 8 - cnt / 2;  // the rays that land empty filled -inf first
  int rank = 0;
  bool nans = false;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (!((has >> k) & 1)) v[k] = rank++ < a ? -CUDART_INF_F : CUDART_INF_F;
    nans |= v[k] != v[k];
  }
  return nans ? select_mid16<true>(v) : select_mid16<false>(v);
}

// A dense tile's walk of one ray from (y, x): the index of the probe it
// lands on, -1 if it lands empty. Chunks of Q probes start at odd t (Q is
// even), so a probe's offset from its chunk's first is a constant.
template <int DX2, int DY2>
__device__ __forceinline__ int walk_chunks(const float* __restrict__ lab,
                                           int y, int x, int H, int W) {
  static_assert(Q % 2 == 0, "chunks start at odd t");
  const int t0 = min(first_out(DX2, x, W), first_out(DY2, y, H));
  const int dj = (ray_step<DY2>(1 + Q) - ray_step<DY2>(1)) * W
                 + ray_step<DX2>(1 + Q) - ray_step<DX2>(1);
  int j = (y + ray_step<DY2>(1)) * W + x + ray_step<DX2>(1);
  for (int t = 1; t < t0; t += Q, j += dj) {
    float l[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int o = (ray_step<DY2>(1 + i) - ray_step<DY2>(1)) * W
                    + ray_step<DX2>(1 + i) - ray_step<DX2>(1);
      l[i] = t + i < t0 ? lab[j + o] : MISMATCH;
    }
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int o = (ray_step<DY2>(1 + i) - ray_step<DY2>(1)) * W
                    + ray_step<DX2>(1 + i) - ray_step<DX2>(1);
      if (l[i] != MISMATCH) return j + o;
    }
  }
  return -1;
}

// A sparse tile's walk of the MISMATCH pixel (y, x) by one warp (every lane
// calls it); stop, next and land: the warp's 16 ints each in shared memory.
__device__ __forceinline__ void walk_warp(const float* __restrict__ d0,
                                          const float* __restrict__ lab,
                                          float* __restrict__ out, int y,
                                          int x, int H, int W, int* stop,
                                          int* next, int* land) {
  const int lane = threadIdx.x & 31;
  if (lane < 16) {
    stop[lane] = INT_MAX;
    next[lane] = 1;
    land[lane] = -1;
  }
  __syncwarp();
  unsigned open = 0xffffu;  // the rays with no event yet
  while (open) {
    const int m = __popc(open), L = 32 / m;
    int r = 0, ev = INT_MAX, jv = -1;
    if (lane < m * L) {
      r = __fns(open, 0, lane % m + 1);
      const int cx = ray_c2(RAYS_DX2, r), cy = ray_c2(RAYS_DY2, r);
      const int t0 = min(first_out(cx, x, W), first_out(cy, y, H));
      const int tb = next[r] + lane / m;
      float l[P];
      int j[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int t = tb + L * i;
        j[i] = (y + ((t * cy + 1) >> 1)) * W + x + ((t * cx + 1) >> 1);
        l[i] = t < t0 ? lab[j[i]] : MISMATCH;
      }
      // the lane's earliest event: out of frame or excluded (empty), or a
      // probe that is not MISMATCH (landed)
#pragma unroll
      for (int i = P - 1; i >= 0; --i) {
        const int t = tb + L * i;
        if (t >= t0 || l[i] != MISMATCH) {
          ev = t;
          jv = t < t0 ? j[i] : -1;
        }
      }
      if (ev != INT_MAX) atomicMin(&stop[r], ev);
    }
    __syncwarp();
    if (ev != INT_MAX && stop[r] == ev) land[r] = jv;  // the ray's owner
    __syncwarp();
    const bool still = lane < 16 && stop[lane] == INT_MAX;
    if (still) next[lane] += L * P;
    open = __ballot_sync(FULL, still);
    __syncwarp();
  }
  float v = 0.f;
  bool has = false;
  if (lane < 16) {
    const int j = land[lane];
    has = j >= 0;
    if (has) v = d0[j];
  }
  const unsigned hm = __ballot_sync(FULL, has);
  float vals[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) vals[k] = __shfl_sync(FULL, v, k);
  const size_t i = (size_t)y * W + x;
  if (lane == 0) out[i] = median_of_rays(vals, hm, d0[i]);
  __syncwarp();
}

__global__ void __launch_bounds__(NT)
mismatch_fill_kernel(const float* __restrict__ d0,
                     const float* __restrict__ lab, float* __restrict__ out,
                     int H, int W) {
  __shared__ int count[NW];
  __shared__ short list[NT];
  __shared__ int stop[NW][16], next[NW][16], land[NW][16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = blockIdx.x * TX + threadIdx.x % TX;
  const int y = blockIdx.y * TY + threadIdx.x / TX;
  const size_t i = (size_t)y * W + x;
  bool mm = false;
  float v0 = 0.f;
  if (x < W && y < H) {
    v0 = d0[i];
    mm = lab[i] == MISMATCH;
    if (!mm) out[i] = v0;
  }
  const unsigned b = __ballot_sync(FULL, mm);
  if (lane == 0) count[warp] = __popc(b);
  __syncthreads();
  int n = 0, at = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    at += w < warp ? count[w] : 0;
    n += count[w];
  }
  if (n == 0) return;
  if (n > DENSE) {
    if (!mm) return;
    int js[16];
#define RAY(k, dx2, dy2) js[k] = walk_chunks<dx2, dy2>(lab, y, x, H, W);
    RAYS(RAY)
#undef RAY
    float v[16];
    unsigned has = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      v[k] = js[k] >= 0 ? d0[js[k]] : 0.f;
      has |= (unsigned)(js[k] >= 0) << k;
    }
    out[i] = median_of_rays(v, has, v0);
    return;
  }
  if (mm) list[at + __popc(b & ((1u << lane) - 1))] = (short)threadIdx.x;
  __syncthreads();
  for (int k = warp; k < n; k += NW) {
    const int t = list[k];
    walk_warp(d0, lab, out, blockIdx.y * TY + t / TX, blockIdx.x * TX + t % TX,
              H, W, stop[warp], next[warp], land[warp]);
  }
}

// The plain path's output (x, y), (lx, ly) in the tile: its 25 taps in
// dx-outer order, the out-of-frame ones filled -inf for the first 12 - cnt / 2
// of them and +inf for the rest, then the plain network.
__device__ __forceinline__ float median_plain(const float (&tile)[TY + 4][TX + 4],
                                              int lx, int ly, int x, int y,
                                              int H, int W) {
  const int cnt = (min(x + 2, W - 1) - max(x - 2, 0) + 1)
                  * (min(y + 2, H - 1) - max(y - 2, 0) + 1);
  const int a = 12 - cnt / 2;  // the out-of-frame taps filled -inf first
  float v[25];
  int rank = 0;
  bool nans = false;
#pragma unroll
  for (int dx = -2; dx <= 2; ++dx) {
#pragma unroll
    for (int dy = -2; dy <= 2; ++dy) {
      const int k = (dx + 2) * 5 + dy + 2;
      const bool ok = x + dx >= 0 && x + dx < W && y + dy >= 0 && y + dy < H;
      v[k] = ok ? tile[ly + dy + 2][lx + dx + 2]
                : (rank++ < a ? -CUDART_INF_F : CUDART_INF_F);
      nans |= v[k] != v[k];
    }
  }
  return nans ? select_mid25<true>(v) : select_mid25<false>(v);
}

// NaN or -0.0: the values the fast path leaves to the plain one.
__device__ __forceinline__ bool unordered(float v) {
  return v != v || __float_as_uint(v) == 0x80000000u;
}

// A warp a 32 x 8 tile, MW tiles a block stacked down the rows. vec: W even
// and img 8-byte aligned, so the tile's rows load as float2.
__global__ void __launch_bounds__(32 * MW)
median5_kernel(const float* __restrict__ img, float* __restrict__ out, int H,
               int W, bool vec) {
  __shared__ __align__(16) float tiles[MW][TY + 4][TX + 4];
  // bit c of bads[w][r]: warp w's tile value (r, c) a NaN or -0.0 in frame
  __shared__ unsigned long long bads[MW][TY + 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * TX, y0 = (blockIdx.y * MW + warp) * TY;
  if (y0 >= H) return;  // a whole warp
  float (&tile)[TY + 4][TX + 4] = tiles[warp];
  unsigned long long (&bad)[TY + 4] = bads[warp];
  if (lane < TY + 4) bad[lane] = 0;
  __syncwarp();
  bool any = false;
  if (vec) {
    // x0 - 2 is even and so is W: a pair lies in frame or out of it whole;
    // every load issued before any is stored
    constexpr int PAIRS = (TY + 4) * (TX + 4) / 2, N = (PAIRS + 31) / 32;
    float2 q[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int k = lane + 32 * i;
      const int ty = k / ((TX + 4) / 2), tx = 2 * (k % ((TX + 4) / 2));
      const int gy = y0 + ty - 2, gx = x0 + tx - 2;
      q[i] = make_float2(0.f, 0.f);
      if (k < PAIRS && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        q[i] = *reinterpret_cast<const float2*>(img + (size_t)gy * W + gx);
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int k = lane + 32 * i;
      const int ty = k / ((TX + 4) / 2), tx = 2 * (k % ((TX + 4) / 2));
      if (k < PAIRS) {
        *reinterpret_cast<float2*>(&tile[ty][tx]) = q[i];
        const unsigned f = unordered(q[i].x) | unordered(q[i].y) << 1;
        if (f) {
          atomicOr(&bad[ty], (unsigned long long)f << tx);
          any = true;
        }
      }
    }
  } else {
    constexpr int CELLS = (TY + 4) * (TX + 4), N = (CELLS + 31) / 32;
    float q[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int k = lane + 32 * i;
      const int gy = y0 + k / (TX + 4) - 2, gx = x0 + k % (TX + 4) - 2;
      q[i] = k < CELLS && gy >= 0 && gy < H && gx >= 0 && gx < W
                 ? img[(size_t)gy * W + gx] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int k = lane + 32 * i;
      if (k < CELLS) {
        tile[k / (TX + 4)][k % (TX + 4)] = q[i];
        if (unordered(q[i])) {
          atomicOr(&bad[k / (TX + 4)], 1ull << (k % (TX + 4)));
          any = true;
        }
      }
    }
  }
  any = __any_sync(FULL, any);
  __syncwarp();
  const int lx = lane % (TX / MX) * MX, ly = lane / (TX / MX) * MY;
  const int x = x0 + lx, y = y0 + ly;
  bool fast = x >= 2 && x + MX + 1 < W && y >= 2 && y + MY + 1 < H;
  if (any && fast) {  // the lane's (MY + 4) x (MX + 4) union
    unsigned long long u = 0;
#pragma unroll
    for (int r = 0; r < MY + 4; ++r) u |= bad[ly + r];
    fast = ((u >> lx) & ((1ull << (MX + 4)) - 1)) == 0;
  }
  if (fast) {
    float in[MY + 4][MX + 4];
#pragma unroll
    for (int r = 0; r < MY + 4; ++r) {
#pragma unroll
      for (int c = 0; c < MX + 4; c += 4) {
        const float4 q = *reinterpret_cast<const float4*>(&tile[ly + r][lx + c]);
        in[r][c] = q.x;
        in[r][c + 1] = q.y;
        in[r][c + 2] = q.z;
        in[r][c + 3] = q.w;
      }
    }
    float o[MX * MY];
#define I(n, r, c) const float t##n = in[r][c];
#define N(d, a, b) const float t##d = fminf(t##a, t##b);
#define X(d, a, b) const float t##d = fmaxf(t##a, t##b);
#define O(k, s) o[k] = t##s;
    MEDIAN5_FAST_IN(I)
    MEDIAN5_FAST_NET(N, X, O)
#undef I
#undef N
#undef X
#undef O
#pragma unroll
    for (int r = 0; r < MY; ++r) {
      float* row = out + (size_t)(y + r) * W + x;
      if (vec) {
#pragma unroll
        for (int c = 0; c < MX; c += 2) {
          *reinterpret_cast<float2*>(row + c) =
              make_float2(o[r * MX + c], o[r * MX + c + 1]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < MX; ++c) row[c] = o[r * MX + c];
      }
    }
  }
  // the plain path: the outputs of every other lane with one in frame,
  // shared out over the warp
  const unsigned plain = __ballot_sync(FULL, !fast && x < W && y < H);
  const int n = __popc(plain) * MX * MY;
  for (int k = lane; k < n; k += 32) {
    const int g = __fns(plain, 0, k / (MX * MY) + 1), m = k % (MX * MY);
    const int px = g % (TX / MX) * MX + m % MX, py = g / (TX / MX) * MY + m / MX;
    if (x0 + px < W && y0 + py < H) {
      out[(size_t)(y0 + py) * W + x0 + px] =
          median_plain(tile, px, py, x0 + px, y0 + py, H, W);
    }
  }
}

template <typename S>
__device__ __forceinline__ float widen(S v);
template <>
__device__ __forceinline__ float widen<float>(float v) { return v; }
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float widen<__half>(__half v) {
  return __half2float(v);
}

// out[y, x] from d = (int)d0[y, x] and vol at (y, c, d - 1 .. d + 1), with
// c = W - 1 - x for x-reversed storage, else x; strides in elements.
template <typename S>
__global__ void __launch_bounds__(NT)
subpixel_kernel(const float* __restrict__ d0, const S* __restrict__ vol,
                float* __restrict__ out, int H, int W, long long sy,
                long long sx, long long sd, int Dp, bool xrev, int disp_max,
                float thresh) {
  const int x = blockIdx.x * TX + threadIdx.x % TX;
  const int y = blockIdx.y * TY + threadIdx.x / TX;
  if (x >= W || y >= H) return;
  const size_t i = (size_t)y * W + x;
  const int d = (int)d0[i];  // truncation, saturating, as astype(int32)
  const S* base = vol + y * sy + (long long)(xrev ? W - 1 - x : x) * sx;
  float c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int j = (int)((unsigned)d + (unsigned)(k - 1));  // int32 wrap
    c[k] = j >= 0 && j < Dp ? widen<S>(base[j * sd]) : 0.f;
  }
  const float cn = c[0], cz = c[1], cp = c[2];
  const float denom =
      __fmul_rn(2.f, __fsub_rn(__fadd_rn(cp, cn), __fmul_rn(2.f, cz)));
  const float df = (float)d;
  float r = df;
  if (d >= 1 && d < disp_max - 1 && denom > thresh) {
    const float q = __fdiv_rn(__fsub_rn(cp, cn), denom);
    r = __fsub_rn(df, q != q ? q : fminf(fmaxf(q, -1.f), 1.f));
  }
  out[i] = r;
}

// A thread's run of OCC_V columns from c0 of a row: the values, and bit i
// of mt (oc) set where column c0 + i is in the row and MATCH (OCCLUSION).
// vec: W even and both maps 8-byte aligned.
__device__ __forceinline__ void occlusion_run(const float* __restrict__ d0,
                                              const float* __restrict__ lab,
                                              int c0, int W, bool vec,
                                              float (&v)[OCC_V], unsigned& mt,
                                              unsigned& oc) {
  float l[OCC_V];
  if (vec && c0 + OCC_V <= W) {
#pragma unroll
    for (int i = 0; i < OCC_V; i += 2) {
      const float2 a = *reinterpret_cast<const float2*>(d0 + c0 + i);
      const float2 b = *reinterpret_cast<const float2*>(lab + c0 + i);
      v[i] = a.x;
      v[i + 1] = a.y;
      l[i] = b.x;
      l[i + 1] = b.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < OCC_V; ++i) {
      const bool in = c0 + i < W;
      v[i] = in ? d0[c0 + i] : 0.f;
      l[i] = in ? lab[c0 + i] : MISMATCH;
    }
  }
  mt = oc = 0;
#pragma unroll
  for (int i = 0; i < OCC_V; ++i) {
    mt |= (unsigned)(l[i] == MATCH) << i;
    oc |= (unsigned)(l[i] == OCCLUSION) << i;
  }
}

__device__ __forceinline__ void occlusion_store(float* __restrict__ out,
                                                int c0, int W, bool vec,
                                                const float (&v)[OCC_V]) {
  if (vec && c0 + OCC_V <= W) {
#pragma unroll
    for (int i = 0; i < OCC_V; i += 2) {
      *reinterpret_cast<float2*>(out + c0 + i) = make_float2(v[i], v[i + 1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < OCC_V; ++i) {
      if (c0 + i < W) out[c0 + i] = v[i];
    }
  }
}

// A block a row (row blockIdx.x) of occlusion_threads(W) threads.
// Values move and are compared with nothing, so their bits are kept.
__global__ void __launch_bounds__(OCC_MAX_NT)
occlusion_fill_kernel(const float* __restrict__ d0,
                      const float* __restrict__ lab, float* __restrict__ out,
                      int W, bool vec) {
  // each warp of the segment: 1 << warp if it holds a match, else 0; the
  // value of its last and of its first match
  __shared__ unsigned wbit[32];
  __shared__ float wlast[32], wfirst[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, seg = blockDim.x * OCC_V;
  const size_t base = (size_t)blockIdx.x * W;
  bool carry_has = false, row_has = false;  // a match in earlier segments;
  float carry = 0.f, row_first = 0.f;       // the last one, the row's first
  for (int s0 = 0; s0 < W; s0 += seg) {
    const int c0 = s0 + threadIdx.x * OCC_V;
    float v[OCC_V];
    unsigned mt = 0, oc = 0;
    occlusion_run(d0 + base, lab + base, c0, W, vec, v, mt, oc);
    // the run's last and first match
    float lv = 0.f, fv = 0.f;
#pragma unroll
    for (int i = 0; i < OCC_V; ++i) {
      if ((mt >> i) & 1) lv = v[i];
      if ((mt >> (OCC_V - 1 - i)) & 1) fv = v[OCC_V - 1 - i];
    }
    // the lanes with a match: the nearest one before this lane's run, and
    // the warp's last and first
    const unsigned m = __ballot_sync(FULL, mt != 0);
    const unsigned before = m & ((1u << lane) - 1);
    const float ev = __shfl_sync(FULL, lv, before ? 31 - __clz(before) : 0);
    const float wl = __shfl_sync(FULL, lv, m ? 31 - __clz(m) : 0);
    const float wf = __shfl_sync(FULL, fv, m ? __ffs(m) - 1 : 0);
    if (lane == 0) {
      wbit[warp] = m ? 1u << warp : 0u;
      wlast[warp] = wl;
      wfirst[warp] = wf;
    }
    __syncthreads();
    unsigned M = 0;  // the block's warps with a match
    for (int k = 0; k < nw; ++k) M |= wbit[k];
    bool eh = before != 0;
    float left = ev;  // the last match left of the run
    if (!eh) {
      const unsigned prev = M & ((1u << warp) - 1);
      if (prev) {
        eh = true;
        left = wlast[31 - __clz(prev)];
      } else if (carry_has) {
        eh = true;
        left = carry;
      }
    }
    const bool found = !row_has && M;  // the row's first match in this segment
    if (found) {
      row_has = true;
      row_first = wfirst[__ffs(M) - 1];
    }
    if (M) {  // the last match for the next segment
      carry_has = true;
      carry = wlast[31 - __clz(M)];
    }
#pragma unroll
    for (int i = 0; i < OCC_V; ++i) {
      if ((mt >> i) & 1) {
        eh = true;
        left = v[i];
      } else if ((oc >> i) & 1) {
        v[i] = eh ? left : row_has ? row_first : v[i];
      }
    }
    occlusion_store(out + base, c0, W, vec, v);
    // the segments before the row's first match hold no match: their
    // occlusions kept their own values, and take that match's now
    if (found) {
      for (int r0 = threadIdx.x * OCC_V; r0 < s0; r0 += seg) {
        occlusion_run(d0 + base, lab + base, r0, W, vec, v, mt, oc);
#pragma unroll
        for (int i = 0; i < OCC_V; ++i) {
          if ((oc >> i) & 1) v[i] = row_first;
        }
        occlusion_store(out + base, r0, W, vec, v);
      }
    }
    if (s0 + seg < W) __syncthreads();  // the arrays are read before reuse
  }
}

dim3 tiles(int H, int W) { return dim3((W + TX - 1) / TX, (H + TY - 1) / TY); }

bool aligned8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }

}  // namespace

// Every entry: (H, W) float32 maps, contiguous, on the card; returns
// cudaGetLastError() after its one launch on `stream`.

extern "C" int occlusion_fill_launch(const float* d0, const float* lab,
                                     float* out, int H, int W,
                                     cudaStream_t stream) {
  const bool vec = W % 2 == 0 && aligned8(d0) && aligned8(lab) && aligned8(out);
  occlusion_fill_kernel<<<H, occlusion_threads(W), 0, stream>>>(d0, lab, out,
                                                               W, vec);
  return (int)cudaGetLastError();
}

extern "C" int mismatch_fill_launch(const float* d0, const float* lab,
                                    float* out, int H, int W,
                                    cudaStream_t stream) {
  mismatch_fill_kernel<<<tiles(H, W), NT, 0, stream>>>(d0, lab, out, H, W);
  return (int)cudaGetLastError();
}

extern "C" int median5_launch(const float* img, float* out, int H, int W,
                              cudaStream_t stream) {
  const bool vec = W % 2 == 0 && aligned8(img) && aligned8(out);
  const dim3 grid((W + TX - 1) / TX, ((H + TY - 1) / TY + MW - 1) / MW);
  median5_kernel<<<grid, 32 * MW, 0, stream>>>(img, out, H, W, vec);
  return (int)cudaGetLastError();
}

// vol: the first sample's address; sy, sx, sd: the strides in elements of
// the volume's row, column and disparity axes; Dp: the disparities it holds;
// storage 0 float32, 1 bfloat16, 2 float16; xrev: the columns x-reversed.
// Returns cudaErrorInvalidValue for another storage code.
extern "C" int subpixel_launch(const float* d0, const void* vol, float* out,
                               int H, int W, long long sy, long long sx,
                               long long sd, int Dp, int storage, int xrev,
                               int disp_max, float thresh,
                               cudaStream_t stream) {
  const dim3 grid = tiles(H, W);
  switch (storage) {
    case 0:
      subpixel_kernel<float><<<grid, NT, 0, stream>>>(
          d0, static_cast<const float*>(vol), out, H, W, sy, sx, sd, Dp,
          xrev != 0, disp_max, thresh);
      break;
    case 1:
      subpixel_kernel<__nv_bfloat16><<<grid, NT, 0, stream>>>(
          d0, static_cast<const __nv_bfloat16*>(vol), out, H, W, sy, sx, sd,
          Dp, xrev != 0, disp_max, thresh);
      break;
    case 2:
      subpixel_kernel<__half><<<grid, NT, 0, stream>>>(
          d0, static_cast<const __half*>(vol), out, H, W, sy, sx, sd, Dp,
          xrev != 0, disp_max, thresh);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
